#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sda_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build: compile every kernel of the main path from ``sda_tpu_torch/ops/csrc``
   (the three variants of ``mxu8.cu``, ``chacha.cu``, ``mxu7.cu`` and
   ``planar_cios.cu``, one nvcc each, all started together; set-up), print
   ptxas's registers and spills for every instantiation, the SASS opcode
   counts (``cuobjdump -sass``) of the ChaCha, planar and headline mxu7 and
   mxu8 kernels, and the card's name and power limit; B1's, B3's and B6's
   registers and spills against ``KEPT_PTXAS``. The B1-B3, B6 and B7
   bounds count the instructions of the built kernels' generator and
   participant loops;
2. compare: at a mid shape (16 participants per chunk, 3,000 dimensions,
   lanes=1024) run each kernel on the card and its plain version on CPU
   copies of the same inputs at four moduli, in caller-randomness and PRNG
   mode; every output must be bit-equal. B1: with and without fused
   reconstruction, rand_participants = P and 1. B2: 2 and 3 chunks, with
   and without reconstruction. B3: onto a non-zero canonical accumulator.
   B2 must also equal the B1 + B3 streaming loop at the same seed (PRNG).
   Then the ring cases (``RING_CASES``: K below one tile, below the ring's
   depth and not a multiple of 64, other randomness draw counts, 128 bits,
   lanes past NBP, the narrower copy paths, the ones row inside the MMA's
   tiles), each through B1, B2 with 3 chunks (at the card's split count
   and at S = 1, 2, 5 and more splits than K tiles) and B3, bit-equal;
3. headline: ``FederatedAggregation.packed_64bit(dimension=1_000_002)`` with
   768 participants through ``engine.aggregate_mxu8_kernel``: one step with
   the launch counters reset before and read after, the reveal checked on
   the first 128 lanes against the modular participant sum, the plain
   version run on the card at the same shape and compared, then timed
   steps with CUDA events; the launch's shared memory per block and blocks
   per SM (the CUDA occupancy calculator) and its instance's ptxas
   registers and spills; the bound is the largest of bytes, int8
   operations and the Philox calls' SASS instructions at the issue rate;
4. config 3: ``packed_128bit(dimension=10_002)``, 2 chunks x 512
   participants, lanes 512, through ``engine.aggregate_mxu8_kernel_chunked``:
   exactly one B2 call for the step (a memset, ``mxu8_split_kernel`` on
   NBP / 128 x S blocks, at least one per SM, and ``mxu8_epilogue_kernel``),
   the reveal on the first 512 lanes, the kernels against their plain
   version on the card, timed steps (and the card's own time: windows of
   steps queued behind a stream spin); S, the grid, both kernels' shared
   memory, blocks per SM, registers and spills; the kernels' device times
   from a ``torch.profiler`` trace, the split kernel's halves through cut
   plans at the same S (K tiles without randomness, draws behind one tile a
   chunk, neither), and the whole call at other split counts;
5. config 4: ``packed_64bit(dimension=1_000_002)``, 14 chunks x 768
   participants (10,752; one resident chunk re-read per chunk) through
   ``engine.aggregate_mxu8_kernel_streaming``: B1 x 2 and B3 x 13 for the
   step, the reveal on the first 128 lanes, one B3 launch against its plain
   version on the card, timed steps, and the back-to-back step on the host
   clock with the device idle share (from the kernels' event times, and
   from a ``torch.profiler`` trace of one step);
6. serving: ``packed_64bit(dimension=1_002)``, 100 participants, 512 jobs x
   384 lanes through ``concat_jobs_lanes`` + ``aggregate_mxu8_kernel_jobs``
   with ``combined_randomness`` False and True: one launch each, jobs 0, 1
   and 511 revealed in full, the kernel against its plain version, timed;
7. forward: the CIOS ``forward`` of the headline model at 32 participants
   must reveal the numpy sum mod p;
8. chacha compare: ``csrc/chacha.cu``'s B4 (keystream) and B5 (fused fold)
   on the card against their plain versions on CPU copies, bit-equal: B4
   at the RFC zero-seed vector and 300 seeds x 257 blocks,
   ``expand_masks_device`` at four moduli, B5 at 2^63 - 871 and 2^55 - 55
   (1,100 seeds x 264 dimensions, also against the host oracle), B5 with
   its rejection zone lowered to draws >= 2^62 (about 3/4 of them hit:
   the per-seed counts against the plain version's, and the fused route's
   host fix-up of every seed that hit), 16,500 seeds through
   ``combine_masks_device`` (exactly 2 B5 launches) and the
   forced-rejection modulus 2^62 + 1 with and without the host fix-up;
9. chacha reveal: 10,000 seeds x 1,000,002 dimensions at 2^63 - 871
   through ``ChaChaMasker(...).combine`` on the forced device route: one B5
   launch per combine, exact on dimensions [0, 512), the last 514 and the
   8 draws of every 1,000th block counter against a numpy oracle, the B5
   launch timed with CUDA events and the whole combine (the masker with
   every default: the card's device route) on the host clock, beside the
   launch's bound;
   then the fused recombine at 16,384 seeds x 2^20 (one group) and 16,385
   (two groups, the first seed of each marked rejected and its exact mask
   traded), bit-equal to the host recombine the route had before and
   exact on the windows, and the host tail and the unmask's subtract by
   either route on the host clock (``fused recombine:``, two lines);
10. chunk route: 256 seeds x 1,000,002 through ``combine_masks_device``
    (two B4 launches), exact on the same windows, timed;
11. full-mask reveal: 64 masks x 1,000,002 through ``FullMasker(...)
    .combine`` on the forced device route (``device_combine``), equal to
    the host fold;
12. mxu7 compare: ``csrc/mxu7.cu`` (B6) on the card against its plain
    version on CPU copies at the mid shape (16 participants, 3,000
    dimensions, lanes 1024) and the four moduli of ``_engines``, bit-equal:
    caller randomness, PRNG rand-sum (P = 16) and PRNG grouped (P = 131),
    each combined only, ``out7`` and with fused reconstruction, plus the
    reconstruct-only call; then B6's ring cases (``RING7_CASES``: K below
    one tile, below the ring and not a multiple of 64, several tiles, NBP
    100 and 101 for the 4-byte and byte copies, lanes past NBP in the last
    block, the 128-bit field, p433), each in caller-randomness, rand-sum
    and grouped (``P_GROUPED``) mode, combined, ``out7`` and reconstructed
    (the reveal checked), plus the reconstruct-only call, bit-equal;
    ``share_mxu`` against the CIOS ``share`` and the ``aggregate_mxu``
    reveal (``torch._int_mm``) on the card;
13. gen-3 headline: ``packed_64bit(dimension=1_000_002)``, 768 participants,
    PRNG mode, through ``engine.aggregate_mxu_kernel``: exactly one B6
    launch for the step, the reveal on the first 128 lanes, the plain
    version on the card at the same shape, 20 steps timed with CUDA
    events, the launch's shared memory per block, blocks per SM and its
    instance's ptxas registers and spills, and the launch's phases timed
    apart (the K loop without randomness, the randomness behind a one-tile
    K loop, neither); then the same width in caller-randomness mode
    (48,384 rows, one launch, reveal-checked);
14. gen-3 streaming: 14 chunks x 768 (one resident chunk re-read) through
    ``engine.aggregate_mxu_kernel_streaming``: B6 x 15 for the step, the
    reveal on the first 128 lanes, 5 steps timed and the back-to-back step
    on the host clock, the chunk's and the reconstruction's launch report;
15. planar compare: ``csrc/planar_cios.cu`` (B7) against its plain version
    on CPU copies at the mid shape, PRNG and caller randomness, at p433,
    the additive scheme mod 2^61 - 1, a 62-bit prime and 2^127 - 1495;
16. gen-1 headline: the same model, 768 x 1,000,002, through
    ``engine.aggregate_fused`` (rows 8): one B7 launch and the CIOS
    reconstruction per step, the reveal on the first 128 lanes, the plain
    version on the card on the first 1,024 lanes, the launch and the step
    timed; ``aggregate_fused_streaming`` over 3 chunks x 64 participants of
    the same width equal to the one-shot ``aggregate_fused_ext`` result;
17. probe compare: ``csrc/probes.cu``'s floor probes on the card against
    their plain versions on CPU copies, at the shapes their tools give
    them: T1 at the config-2 job (2,400 rows x 384 lanes), T1' (1 KB in,
    4 KB out), T2 at the serving batch (2,400 x 196,608), T3 at config 3
    (2 chunks x 24,576 rows x 3,584 lanes, on B2's split grid at B2's S):
    each output seed-filled and
    bit-equal, each block's sink bit-equal, and the XOR of the sinks equal
    to torch's XOR of the input's words on the card (the proof that every
    byte was read); then each probe, its plain version on the card and the
    library call (a torch sum of the input's words and a fill) timed;
18. tools: ``sda_tpu_torch.tools.measure_latency_floor`` (T1, T1'),
    ``measure_lane_batch_floor`` (T2) and ``measure_config3_variants``
    (T3) at the reference's shapes, each with the counters set to 0 just
    before it and read just after (its probe and its real kernel must have
    launched), every reveal checked; each writes its artifact to
    ``build/measurements/`` and gets one line of headline figures;
19. mesh: the multi-device pipeline (``sda_tpu_torch.parallel``) in a
    world of one on NCCL, ``make_mesh(MESH_AXES)`` with no launcher, at
    full width (``packed_64bit(dimension=1_000_002)``, 768 participants):
    the jnp step (32 participants, no kernel), the gen-3 step (B6 x 2) in
    PRNG and caller-randomness mode, a 15-chunk gen-3 stream (B6 x 16),
    the gen-4 step (B1 x 2), the config-4 stream (B1 x 2, B3 x 13), two
    lane-batched jobs (B1 x 2), the caller-randomness gen-4 step and a
    2-chunk stream, the chunk loop once and two degraded finishes
    (dropping clerks 0 and 5, B1 x 1 each). Every step's launches are
    counted exactly, every reveal checked, every caller-randomness output
    bit-equal to the engine's single-device entry point on the same inputs
    (``aggregate``, ``aggregate_mxu_kernel``, ``aggregate_mxu8_kernel``,
    ``aggregate_mxu8_kernel_streaming``; the degraded finishes to the full
    one); each step is timed with CUDA events beside that entry point, and
    the gen-3 and gen-4 steps' device time split by torch op
    (``torch.profiler``);
20. drivers: ``sda_tpu_torch.graft_entry.entry()``'s forward step (16 x
    1,024, CIOS, no kernel) revealed exactly; ``dryrun_multichip(1)``, the
    reference dryrun's seven checks in a world of one on NCCL (B6 x 5, B1
    x 8, B3 x 3, counted exactly); then the scaling bench
    (``sda_tpu_torch.tools.bench_scaling``) in a world of one: the config-5
    split at full width, 131 chunks x 768 participants x 1,000,002
    dimensions (one 6.15 GB planar buffer re-read by every chunk): the
    chunk loop (B1 x 1 + B3 x 130) and the finish (B1 x 1), each counted,
    the reveal checked on the first 512 lanes, the loop timed 3 times and
    the finish 5 with CUDA events beside their bounds; and the weak-scaling
    row n = 1 (768 x 1,000,002, B1 x 2 a step), reveal-checked and timed;
21. crypto: the port's sealed boxes and Ed25519
    (``sda_tpu_torch/native/nacl.cpp``, built on this host with
    ``-march=native``) against RFC 7748 § 6.1, RFC 8032 § 7.1 tests 1-3
    and vectors libsodium made (``SODIUM_BOX``, ``SODIUM_SIGS``), mutated
    signatures refused; the host time per call of X25519, ``seal`` and
    ``seal_open`` (1 KB and one clerk's 1,000,002 / 3 values),
    ``sign_detached`` and ``verify_detached``, and what
    ``ctypes.util.find_library('sodium')`` finds;
22. full loop: ``bench.py:_bench_system_e2e``'s ``run_loop`` on the port,
    ``serve_background`` over a jsondir store: pass A, 1,000 participants
    x 1,002 under ChaCha masking (8 workers), whose reveal is exact,
    launches B5 once and B4 never, after all 8 clerk jobs took the fused
    native open + combine (``client.combine_routes``); pass B, 8 x
    1,000,002, no masking, every client on the bulk route (4 workers): the
    reveal exact, the participants' ``share_mxu`` and the recipient's
    reconstruction on the card; build, ingest, snapshot, drain and reveal
    on the host clock, the wire's MB; then B5 alone at pass A's reveal
    shape;
23. tolerance: the degraded committee (``TOLERANCE``), one pass of the loop
    at 4 participants x 1,000,002 under ChaCha masking, every client on the
    bulk route, over HTTP: participant 0's participation uploaded twice and
    counted once; one byte of participant 3's box for clerk 7 flipped, so
    clerk 7's fused native open + combine raises ``Invalid``, stores no
    result and its job stays pollable; after clerks 0-5, 6 results and
    ``result_ready`` False, the reveal refused; after clerk 6, 7 results and
    ready; the reveal exact through the recipient's subset branch (0-6) on
    the card, with B4 x 1 (4 seeds: the chunk route); a clerk key with a
    forged signature refused at 1,002 dimensions; then the subset against
    the full-set reconstruction and the chunk against the fused ChaCha
    route at the reveal's shape, with CUDA events;
24. cli: the README walkthrough as processes (``server_cli httpd`` and 23
    ``sda_tpu_torch.cli`` calls), reveal ``0 2 2 4 4 6 6 8 8 10``;
25. tool combine crossover: ``tools.measure_combine_crossover.measure()``
    on the card, the fused native route against the streamed device route
    at the tool's four shapes, written to
    ``build/measurements/CROSSOVER.json``;
26. breakdown: ``utils.profiling.device_breakdown`` of the headline step
    (B1 x 1) and of the mesh's gen-4 step in a world of one (B1 x 2), at
    the end of the script: each kernel's count of device activities a
    multiple of the calls traced and B1's equal to the launch counters',
    the kernels' sum against the step's CUDA-event time, and beside it
    what a plain profiler session (no throwaway session before it) recorded;
27. roofline: ``sda_tpu_torch.tools.bench_roofline.measure()`` at the
    headline's width with the breakdown: the full pipeline and
    combine-only B1 launches, reveals checked, counted, timed beside the
    headline phase, the full pipeline's bound equal to the headline's;
28. chacha native: ``chacha.expand_masks``'s route on the card's host and
    the native expansion against numpy's, bit-equal, at 64 seeds x
    1,000,002 (p = 2^63 - 871) and 4 seeds x 4,096 (p = 2^62 + 1, about
    1/4 of the draws rejected), both on the host clock;
29. example: ``examples/bulk_aggregation_torch.py``'s ``main`` at its
    defaults on the card (torch CIOS, no kernel), its reveal exact;
30. scaling artifact: ``tools.make_scaling_artifact.compose`` on the
    ``drivers:`` phase's own config-5 row: the projection onto 8 (and 4)
    cards, labelled projected, written to ``build/measurements/``.

The second-to-last line is a JSON object describing each kernel (B1, B3
and B6 with the mesh's launches and step times); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or run outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import re
import sys
import time
from pathlib import Path

HEADLINE_DIM = 1_000_002
HEADLINE_P = 768
LANES = 1024
DEVICE = "cuda"  # every tensor of the run lies on the card
CONFIG3 = dict(dimension=10_002, p_chunk=512, n_chunks=2, lanes=512)
CONFIG4 = dict(p_chunk=768, n_chunks=14)
SERVING = dict(dimension=1_002, participants=100, jobs=512, job_lanes=384)
# H100 SXM data-sheet peaks (dense): HBM bytes/s and int8 tensor-core ops/s
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1.979e15
# 32-bit integer issue: 132 SMs, each issuing at most one warp instruction
# per clock on each of its 4 schedulers (128 lanes a clock); the SM's
# dedicated INT32 pipes have 64 lanes, and ptxas moves adds onto the FMA
# pipe (IMAD), so 128, not 64, is the ceiling an integer kernel can reach
SMS = 132
ISSUE_LANES = 128
INT32_LANES = 64
# the reveal is checked on dimensions [0, window), the last tail and the 8
# draws of every stride-th block counter between them
CHACHA = dict(seeds=10_000, dimension=1_000_002, chunk_seeds=256, fullmask=64, window=512,
              tail=514, stride=1000)
# counted 32-bit operations of one ChaCha20 block: 10 double rounds of 8
# quarter rounds (4 adds, 4 xors, 4 rotates each) and 16 final adds; B5
# adds the 4 limb accumulates of each of the block's 8 draws
CHACHA_BLOCK_OPS = 976
FOLD_DRAW_OPS = 4 * 8
GEN1_STREAM = dict(chunks=3, p_chunk=64)
# the multi-device pipeline on the one card: a world of one, every axis 1;
# the gen-3 stream's chunks, the jnp step's participants, the clerks each
# degraded finish drops
MESH_AXES = {"p": 1, "d": 1, "c": 1}
MESH = dict(stream7_chunks=15, jnp_participants=32, drops=(0, 5))
# the drivers: graft_entry's dryrun launches (B6 x 2 + 3 for the gen-3 step
# and its 2-chunk stream; B1 x 2 + B3 for the gen-4 stream, x 2 again for
# each of 2 degraded finishes, B1 x 2 for the 2-job lane batch), and the
# scaling bench's config-5 split at full width: 131 chunks x 768 (100,608
# participants) x 1,000,002 dimensions (BASELINE.md's config 5 on one card)
DRYRUN_LAUNCHES = dict(mxu7_fused=5, mxu8_fused=8, mxu8_acc=3)
CONFIG5 = dict(participants_per_device=768, dim_per_device=333_334, chunks=131)
# the native ChaCha expansion against numpy's: (seeds, dimensions, modulus);
# at 2^62 + 1 about 1/4 of the draws are rejected and numpy takes its
# scalar path, so that case stays small
CHACHA_NATIVE = {"p = 2^63 - 871": (64, 1_000_002, (1 << 63) - 871),
                 "p = 2^62 + 1": (4, 4_096, (1 << 62) + 1)}
# ptxas's (registers, spilled bytes) of B1, B3 and B6's MT1-MT12 instances
# when their times in PERF.md were measured (B6: registers, no spill); a
# change to the kernels' shared code must leave them as they are
KEPT_PTXAS = {
    "mxu8_fused": ((64, 68), (80, 0), (80, 100), (119, 0), (124, 0), (125, 0), (128, 0),
                   (128, 176), (128, 220), (128, 296), (235, 0), (247, 0)),
    "mxu8_acc": ((64, 92), (80, 4), (80, 104), (119, 0), (124, 0), (126, 0), (128, 0),
                 (128, 176), (128, 220), (223, 0), (235, 0), (247, 0)),
    "mxu7_fused": tuple((r, 0) for r in (73, 96, 97, 116, 122, 125, 128, 128, 203, 215, 226, 238)),
}
# the protocol's crypto (sda_tpu_torch/native/nacl.cpp) against published
# vectors: RFC 7748 § 6.1 (X25519: Alice's and Bob's secret and public
# keys, the shared secret) and RFC 8032 § 7.1 tests 1-3 (Ed25519: seed,
# public key, message, signature)
RFC7748 = ("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a",
           "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a",
           "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb",
           "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f",
           "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
RFC8032 = (
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9"
     "b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085ac1e43e15996e458f3613d0f1"
     "1d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff9b538d16f290ae67f760984d"
     "c6594a7c15e9716ed28dc027beceea1ec40a"),
)
# made by libsodium 1.0.18: the sealed box of bytes(range(97)) to the public
# key of BOX_SK with the ephemeral secret key BOX_ESK (epk || crypto_box_easy
# with the BLAKE2b-192 nonce of epk || pk), and (seed, public key, message
# length, signature) of crypto_sign_seed_keypair + crypto_sign_detached on
# bytes(range(length))
SODIUM_BOX = dict(
    sk="563270d47e4fdbd36e9cf68c6efce881fdbd3fdb809d0ef5a2cac30fecb402c5",
    esk="68eb4daa352c1c8c7ca8ebdfe0e857ad47350e085883165d6bd6fb1baf7bd062",
    box="efc8b6c99bd11c7643c3cfd705add447c28c704a09be2c45fb5b5134e4fd9967623792d851cac0900861fb97"
        "bfb95f2eb2c87f0a36d2267f9d6709202f335b4d795f8f10eb4b681de3b18d2fea326879f949e6eeb364b77"
        "38a7831151860eb587ec5bbb4ff103757e70da4c714e1b9ed2f7d1156e2f7669d60675c91606360e42f9972"
        "8d1da331de62fb981d922363df0c")
SODIUM_SIGS = (
    ("0b5b4f11e645714559eb7573bd9c0b81e4044db57f2f4547dd0076881ce94690",
     "5afed69fb141d65634fbd88912d2cef18903be092e320cbf135f091d486b278a", 0,
     "93ce913ac7499b3b59f7dbdfbdd97004dfaa74b5b75b1bc58f03ad43bc9c3ff8e877e86a61d538224917cfd1ec58"
     "43794846372be601a4646954e8d8d3eefc03"),
    ("323447d27a4e79dd32247fa16e88f8b5b192bf6fb845710f5a887f13ba1a9782",
     "d3c29268bf137c5acab65ef87d25b6b258e880fb3793a80234030d21ee37c00b", 200,
     "c282556dfcf7f3f67ad2011cf36211c545007cb572288517460ab67dab023473423873b6c10bfd3c41a4d8ddd024"
     "fc9d0bd6caaf15da0b4462282539a1f9e80a"),
)
ED25519_L = 2**252 + 27742317777372353535851937790883648493
# a y of order 8 (libsodium's small-order list): as R with S = 0 it is refused
SMALL_ORDER_Y8 = "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a"
# the protocol loop (bench.py:_bench_system_e2e's run_loop): pass A, the
# ChaCha pass (every clerk on the bulk route), and pass B, the
# config-4-shaped one (every client on the bulk route)
FULL_LOOP = {"A": dict(dimension=1_002, participants=1_000, masking="chacha", workers=8,
                       all_bulk=False),
             "B": dict(dimension=1_000_002, participants=8, masking="none", workers=4,
                       all_bulk=True)}
# the degraded committee, in one full-width loop over HTTP: participant 0
# uploads twice, participant 3's box for clerk 7 has one byte flipped, clerks
# 0-5 drain (6 results: not ready), then clerk 6 (7 results: the
# reconstruction threshold t + k), the reveal takes the recipient's subset
# branch; then a clerk key with a forged signature at 1,002 dimensions
TOLERANCE = dict(dimension=1_000_002, participants=4, masking="chacha", workers=4,
                 all_bulk=True, stages=((0, 1, 2, 3, 4, 5), (6,)), tamper=(3, 7), retry=0,
                 forged_dimension=1_002)
# the reveal folds 4 seeds: below the 512 seeds from which combine_masks_device
# takes B5 (the rule of sda_tpu/ops/chacha_kernel.py:457 too), so its ChaCha
# combine is the chunk route, one B4 launch
TOLERANCE_LAUNCHES = {"chacha_keystream": 1}
# the 728-clerk committee of FederatedAggregation.packed_tss728 (100 secrets,
# threshold 155, p = 746,497) at d = 2^20 (10,486 batches, NBP 10,496 at 128
# lanes): csrc/mxu8.cu mode 3, the wide plans. Launches of 128 participants
# with the kernel's randomness (51,200 operand rows) and of 64 with the
# caller's (65,280 rows: 128 would pass the carry chain's 65,793), each B1
# then B3 onto it; then the reconstruction from 255 of the 728 clerks. Each
# is held bit-equal to the plain version on the card at full width and on
# the CPU at cpu_lanes lanes.
WIDE = dict(dimension=1 << 20, lanes=128, prng_participants=128, caller_participants=64,
            clerks=255, cpu_lanes=256, seed=22)
# the README walkthrough: its reveal
CLI_REVEAL = "0 2 2 4 4 6 6 8 8 10"


def _ptxas_spills(report: str) -> dict:
    """``label -> (registers, spill-store bytes)`` for every kernel
    instantiation in a ptxas report."""
    from sda_tpu_torch.ops.sass import kernel_label

    out, current, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            spill = max(spill, int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            label = kernel_label(current)
            if label:
                out[label] = (int(m.group(1)), spill)
            current = None
    return out


def _ptxas_summary(report: str) -> str:
    """``label:registers`` for every kernel instantiation in a ptxas
    report, and the largest spill anywhere in it."""
    regs = {label: r for label, (r, _) in _ptxas_spills(report).items()}
    spill = max((int(x) for x in re.findall(r"(\d+) bytes spill stores", report)), default=0)

    def order(k):
        m = re.fullmatch(r"(MT|epi)(\d+)", k)
        return (m.group(1) != "MT", int(m.group(2)), "") if m else (2, 0, k)

    order = sorted(regs, key=order)
    return " ".join(f"{k}:{regs[k]}" for k in order) + f"; max spill {spill} B"


def _opcode_counts(instrs) -> collections.Counter:
    """The count of each opcode (without modifiers) among ``instrs``."""
    return collections.Counter(op.split(".")[0] for _, op, _ in instrs)


def _pipe_counts(instrs) -> dict:
    """``instrs`` split by where they execute: ``fma`` (IMAD and its forms,
    the FMA pipe's 64 integer lanes per SM), ``alu`` (every other vector
    integer instruction: LOP3, LEA, SHF, IADD3, ISETP, ..., the INT32 pipe's
    64 lanes) and ``total`` (all, each one warp issue slot)."""
    other = ("LD", "ST", "ATOM", "RED", "U", "S2", "CS2R", "BRA", "BSSY", "BSYNC", "BAR",
             "EXIT", "NOP", "WARPSYNC", "HMMA", "IMMA", "MOVM")
    fma = sum(1 for _, op, _ in instrs if op.startswith("IMAD"))
    alu = sum(1 for _, op, _ in instrs if not op.startswith("IMAD") and not op.startswith(other))
    return {"total": len(instrs), "fma": fma, "alu": alu}


def _variants() -> dict:
    from sda_tpu_torch.ops import chacha_kernel, mxu8, mxu_kernel, pallas_kernels, probes

    return {**mxu8.KERNEL_VARIANTS, **chacha_kernel.KERNEL_VARIANTS,
            **mxu_kernel.KERNEL_VARIANTS, **pallas_kernels.KERNEL_VARIANTS,
            **probes.KERNEL_VARIANTS}


def phase_build():
    from sda_tpu_torch.ops.cuda_build import build_kernel_libraries, ptxas_report

    variants = _variants()
    t0 = time.perf_counter()
    build_kernel_libraries(variants.values())
    seconds = time.perf_counter() - t0
    return seconds, {name: _ptxas_summary(ptxas_report(*v)) for name, v in variants.items()}


def _reset_counts():
    from sda_tpu_torch.ops import chacha_kernel as ck
    from sda_tpu_torch.ops import mxu8 as m8
    from sda_tpu_torch.ops import mxu_kernel as m7
    from sda_tpu_torch.ops import pallas_kernels as pk
    from sda_tpu_torch.ops import probes

    m8.mxu8_launches = m8.mxu8_chunked_launches = m8.mxu8_acc_launches = 0
    m8.mxu8_wide_launches = 0
    ck.chacha_keystream_launches = ck.chacha_fold_launches = 0
    m7.mxu_fused_launches = pk.fused_planar_launches = 0
    for name in probes.probe_launches:
        probes.probe_launches[name] = 0


def _chacha_counts():
    from sda_tpu_torch.ops import chacha_kernel as ck

    return {"chacha_keystream": ck.chacha_keystream_launches,
            "chacha_fold": ck.chacha_fold_launches}


def _counts():
    from sda_tpu_torch.ops import mxu8 as m8
    from sda_tpu_torch.ops import mxu_kernel as m7
    from sda_tpu_torch.ops import pallas_kernels as pk
    from sda_tpu_torch.ops import probes

    return {"mxu8_fused": m8.mxu8_launches, "mxu8_chunked": m8.mxu8_chunked_launches,
            "mxu8_acc": m8.mxu8_acc_launches, "mxu8_wide": m8.mxu8_wide_launches,
            "mxu7_fused": m7.mxu_fused_launches,
            "planar_cios": pk.fused_planar_launches, **probes.probe_launches}


def _only(**launches) -> dict:
    """The launch counts of a run that launched exactly ``launches``."""
    return {name: launches.get(name, 0) for name in _counts()}


def _engines(dimension: int, names=None):
    """Packed Shamir (3, 8, 4) engines at the four moduli of the reference's
    byte-limb tests: p433, a generic 62-bit prime, 2^63 - 871, 2^127 - 1495
    (or those of them in ``names``)."""
    from sda_tpu_torch.engine import TorchAggregationEngine
    from sda_tpu_torch.fields import find_prime_field, find_special_prime_field
    from sda_tpu_torch.sharing import PackedShamirScheme

    params = {
        "p433": (433, 354, 150),
        "p62": find_prime_field(62, 8, 9),
        "p63special": find_special_prime_field(63, 8, 9),
        "p127special": find_special_prime_field(127, 8, 9),
    }
    return {
        name: TorchAggregationEngine(
            PackedShamirScheme(3, 8, 4, p, w2, w3).device_spec(), dimension, device=DEVICE
        )
        for name, (p, w2, w3) in params.items() if names is None or name in names
    }


# Shapes that stress the K loop's ring of 64-row tiles (4 stages) and its
# ragged edges, at 16 x 3 x 8 = 384 rows per 16 participants in PRNG mode
# (x 7/3 with caller randomness): (what, modulus, participants, dimension,
# lanes, rand_participants). NBP = ceil(dimension / 3) rounded up to lanes,
# so lanes 16 leaves a block's last lanes past NBP, lanes 4 and 1 take the
# 4-byte and the byte copies of sec, and p433's 12 rows the 4-byte copies
# of bigS. The kernel sums the all-ones row n * L8 apart from the MMA; with
# the additive scheme (1 secret, 3 clerks: 24 rows) that row lies inside
# the MMA's m16 tiles, with packed Shamir (64 or 128 rows) just past them.
RING_CASES = (
    ("K below one tile, P=1", "p63special", 1, 300, 16, None),
    ("K below one tile, P=2", "p63special", 2, 300, 16, None),
    ("K between one tile and the ring, not a multiple of 64", "p63special", 5, 300, 16, None),
    ("K of 3 tiles and 24 rows", "p63special", 9, 300, 128, None),
    ("rp=1", "p63special", 16, 300, 16, 1),
    ("rp=4", "p63special", 16, 300, 16, 4),
    ("rp=7", "p63special", 16, 300, 16, 7),
    ("128-bit, 4 word groups", "p127special", 3, 300, 16, 2),
    ("NBP=100: 4-byte sec copies", "p63special", 5, 300, 4, None),
    ("NBP=101: byte sec copies", "p63special", 5, 303, 1, None),
    ("K=12: 4-byte bigS copies", "p433", 2, 300, 16, None),
    ("ones row inside the MMA's tiles (additive, 3 clerks)", "additive61", 4, 300, 16, None),
)
# Plans at the kernels' widest, each in caller-randomness and PRNG mode with
# reconstruction: (what, clerks of an additive scheme, modulus, reconstruction
# outputs: None for the scheme's own). The first two fill MT 12 and MT 11
# with the most randomness columns (Kr_pad 288 and 256), where B2's epilogue
# kernel once kept bigR and big2 whole in shared memory; the third asks for
# more outputs than clerks, which B2's stage 2 takes in two passes.
WIDE_CASES = (
    ("MT 12: 23 clerks, 63-bit", 23, "p63special", None),
    ("MT 11: 11 clerks, 128-bit", 11, "p127special", None),
    ("11 reconstruction outputs from 8 clerks", 8, "p63special", 11),
)


def _ring_inputs(dimension: int, n_parts: int, seed: int):
    """For each modulus of the ring cases at ``dimension``: the engine, and
    ``n_parts`` encoded secrets with and without caller randomness."""
    import numpy as np
    import torch

    from sda_tpu_torch.engine import TorchAggregationEngine
    from sda_tpu_torch.sharing import AdditiveScheme

    engines = _engines(dimension, {c[1] for c in RING_CASES})
    engines["additive61"] = TorchAggregationEngine(
        AdditiveScheme(share_count=3, modulus=(1 << 61) - 1).device_spec(), dimension, device=DEVICE
    )
    out = {}
    for name, eng in engines.items():
        rng = np.random.default_rng(seed)
        secrets = eng.encode_secrets(
            rng.integers(0, min(eng.ctx.p, 1 << 62), size=(n_parts, dimension))
        )
        out[name] = (eng, secrets, torch.cat([secrets, eng.random_ext(n_parts, rng=rng)], dim=2))
    return out


def _wide_inputs(clerks: int, modulus: str, n_out, P: int, dimension: int, seed: int):
    """The engine of a ``WIDE_CASES`` entry (an additive scheme), its
    reconstruction matrix, and ``P`` encoded secrets with and without
    caller randomness."""
    import numpy as np
    import torch

    from sda_tpu_torch.engine import TorchAggregationEngine
    from sda_tpu_torch.fields import find_special_prime_field
    from sda_tpu_torch.sharing import AdditiveScheme

    bits = {"p63special": 63, "p127special": 127}[modulus]
    p = find_special_prime_field(bits, 8, 9)[0]
    eng = TorchAggregationEngine(AdditiveScheme(share_count=clerks, modulus=p).device_spec(),
                                 dimension, device=DEVICE)
    rng = np.random.default_rng(seed)
    rec = eng.spec.reconstruct_matrix
    if n_out is not None:
        rec = rng.integers(0, p, size=(clerks, n_out), dtype=np.int64)
    secrets = eng.encode_secrets(rng.integers(0, min(p, 1 << 62), size=(P, dimension)))
    return eng, rec, secrets, torch.cat([secrets, eng.random_ext(P, rng=rng)], dim=2)


def _ring_plans(eng, rows: int, P: int, rec, rp, n_chunks: int = 1):
    """The same plan on the card and on the CPU."""
    from sda_tpu_torch.ops import mxu8 as m8

    spec = eng.spec
    return [m8.mxu8_plan(eng.mxu8, spec.share_matrix, rows, P, spec.secret_count,
                         spec.randomness_count, reconstruct_matrix=rec, rand_participants=rp,
                         device=device, n_chunks=n_chunks)
            for device in (DEVICE, "cpu")]


def _max_err(got, want) -> int:
    import torch

    return int((got.cpu().to(torch.int64) - want.cpu().to(torch.int64)).abs().max())


def _ring_splits(rows: int):
    """B2's split counts at a ring case of 3 chunks of ``rows`` rows: the
    card's own choice (None), 1, 2 (each split crosses a chunk end), 5, and
    more splits than the K tiles (some splits without any tile or draw)."""
    from sda_tpu_torch.ops.mxu8 import KT

    return (None, 1, 2, 5, 3 * -(-rows // KT) + 3)


def phase_compare_ring():
    """B1, B2 (3 chunks, at every split count of ``_ring_splits``) and B3
    (onto a non-zero accumulator) on the card against their plain versions
    on CPU copies at every ring case, in caller-randomness and PRNG mode,
    with and without fused reconstruction; then the same at the
    ``WIDE_CASES`` with reconstruction (B2 at the card's S, 1 and 2).
    Returns (cases, max_abs_err) per kernel."""
    from sda_tpu_torch.ops import mxu8 as m8

    kernels = ("mxu8_fused", "mxu8_chunked", "mxu8_acc")
    cases, max_err = dict.fromkeys(kernels, 0), dict.fromkeys(kernels, 0)

    def check(kernel, got, want, what):
        err = _max_err(got, want)
        max_err[kernel] = max(max_err[kernel], err)
        if err:
            raise AssertionError(f"{kernel} != plain at ring case {what}: max err {err}")
        cases[kernel] += 1

    inputs = {dim: _ring_inputs(dim, 3 * max(c[2] for c in RING_CASES), 14)
              for dim in {c[3] for c in RING_CASES}}
    for what, name, P, dim, lanes, rp in RING_CASES:
        eng, secrets, ext = inputs[dim][name]
        for mode, x in (("ext", ext), ("prng", secrets)):
            sec8 = m8.planar8_from_batched(eng.mxu8, x[: 3 * P], lanes)
            rows = sec8.shape[0] // 3
            mode_rp = rp if mode == "prng" else None
            label = f"{what} ({name}, {mode}, NBP={sec8.shape[1]}, K={rows})"
            for rec in (None, eng.spec.reconstruct_matrix):
                plan, plan_cpu = _ring_plans(eng, rows, P, rec, mode_rp)
                seed = 2000 + sum(cases.values())
                check("mxu8_fused", m8.run_mxu8(plan, sec8[:rows], seed),
                      m8.run_mxu8(plan_cpu, sec8[:rows].cpu(), seed), label)
                plan, plan_cpu = _ring_plans(eng, rows, P, rec, mode_rp, n_chunks=3)
                want = m8.run_mxu8(plan_cpu, sec8.cpu(), seed, lanes=lanes)
                for splits in _ring_splits(rows):
                    check("mxu8_chunked", m8.run_mxu8(plan, sec8, seed, lanes=lanes, splits=splits),
                          want, f"{label} S={splits or 'chosen'}")
            plan, plan_cpu = _ring_plans(eng, rows, P, None, mode_rp)
            acc = m8.run_mxu8(plan, sec8[:rows], 7)
            if not int(acc.count_nonzero()):
                raise AssertionError(f"the accumulator of ring case {label} is zero")
            check("mxu8_acc", m8.run_mxu8(plan, sec8[rows : 2 * rows], 8, acc_in=acc.clone()),
                  m8.run_mxu8(plan_cpu, sec8[rows : 2 * rows].cpu(), 8, acc_in=acc.cpu().clone()),
                  label)
    lanes, P = 16, 2
    for what, clerks, name, n_out in WIDE_CASES:
        eng, rec, secrets, ext = _wide_inputs(clerks, name, n_out, 3 * P, 300, 15)
        for mode, x in (("ext", ext), ("prng", secrets)):
            sec8 = m8.planar8_from_batched(eng.mxu8, x, lanes)
            rows = sec8.shape[0] // 3
            mode_rp = 4 if mode == "prng" else None
            label = f"{what} ({name}, {mode}, NBP={sec8.shape[1]}, K={rows})"
            seed = 3000 + sum(cases.values())
            plan, plan_cpu = _ring_plans(eng, rows, P, rec, mode_rp)
            check("mxu8_fused", m8.run_mxu8(plan, sec8[:rows], seed),
                  m8.run_mxu8(plan_cpu, sec8[:rows].cpu(), seed), label)
            acc = m8.run_mxu8(plan, sec8[:rows], 7)
            check("mxu8_acc", m8.run_mxu8(plan, sec8[rows : 2 * rows], 8, acc_in=acc.clone()),
                  m8.run_mxu8(plan_cpu, sec8[rows : 2 * rows].cpu(), 8, acc_in=acc.cpu().clone()),
                  label)
            plan, plan_cpu = _ring_plans(eng, rows, P, rec, mode_rp, n_chunks=3)
            want = m8.run_mxu8(plan_cpu, sec8.cpu(), seed, lanes=lanes)
            for splits in (None, 1, 2):
                check("mxu8_chunked", m8.run_mxu8(plan, sec8, seed, lanes=lanes, splits=splits),
                      want, f"{label} S={splits or 'chosen'}")
    return cases, max_err


def phase_compare(P: int = 16, dimension: int = 3000):
    """Kernel (card) against plain version (CPU) at the mid shape. Returns
    (cases, max_abs_err, kernel ms and plain ms of the PRNG + reconstruct
    case at 2^63 - 871)."""
    import numpy as np
    import torch

    from sda_tpu_torch.ops import mxu8 as m8
    from sda_tpu_torch.utils.profiling import cuda_time

    cases, max_err, mid = 0, 0, {}
    for name, eng in _engines(dimension).items():
        spec, ctx = eng.spec, eng.ctx
        rng = np.random.default_rng(11)
        secrets = eng.encode_secrets(rng.integers(0, min(ctx.p, 1 << 62), size=(P, dimension)))
        ext = torch.cat([secrets, eng.random_ext(P, rng=rng)], dim=2)
        modes = [
            ("ext", eng.planar8_ext(ext, LANES), None),
            ("prng", eng.planar8_secrets(secrets, LANES), None),
            ("prng_rp1", eng.planar8_secrets(secrets, LANES), 1),
        ]
        for mode, sec8, rp in modes:
            for rec in (None, spec.reconstruct_matrix):
                plan = m8.mxu8_plan(
                    eng.mxu8, spec.share_matrix, sec8.shape[0], P, spec.secret_count,
                    spec.randomness_count, reconstruct_matrix=rec, rand_participants=rp,
                    device=DEVICE,
                )
                plan_cpu = m8.mxu8_plan(
                    eng.mxu8, spec.share_matrix, sec8.shape[0], P, spec.secret_count,
                    spec.randomness_count, reconstruct_matrix=rec, rand_participants=rp,
                )
                seed = 1234 + cases
                got = m8.run_mxu8(plan, sec8, seed)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = m8.run_mxu8(plan_cpu, sec8.cpu(), seed)
                plain_s = time.perf_counter() - t0
                err = int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())
                max_err = max(max_err, err)
                if err:
                    raise AssertionError(
                        f"kernel != plain at {name} {mode} rec={rec is not None}: max err {err}"
                    )
                if rec is not None and mode != "ext":
                    # PRNG mode: the reconstruction reveals the participant sum
                    out = m8.batched_from_planar_lm(got, eng.nb, spec.secret_count)
                    if not torch.equal(out.to(torch.int64), ctx.sum_mod(secrets, axis=0)):
                        raise AssertionError(f"reveal != modular sum at {name} {mode}")
                if name == "p63special" and mode == "prng" and rec is not None:
                    t = cuda_time(lambda i: m8.run_mxu8(plan, sec8, i), iters=10, warmup=2)
                    mid = {"kernel_ms": t.median_ms, "plain_cpu_ms": plain_s * 1e3,
                           "shape": f"P={P} dim={dimension} NBP={sec8.shape[1]}"}
                cases += 1
    return cases, max_err, mid


def phase_compare_chunked(P: int = 16, dimension: int = 3000):
    """B2 and B3 on the card against their plain version on CPU copies at
    the mid shape; B2 against the B1 + B3 streaming loop in PRNG mode.
    Returns (cases, max_abs_err) per kernel."""
    import numpy as np
    import torch

    from sda_tpu_torch.ops import mxu8 as m8

    cases = {"mxu8_chunked": 0, "mxu8_acc": 0}
    max_err = {"mxu8_chunked": 0, "mxu8_acc": 0}

    def check(kernel, got, want, what):
        err = int((got.cpu().to(torch.int64) - want.cpu().to(torch.int64)).abs().max())
        max_err[kernel] = max(max_err[kernel], err)
        if err:
            raise AssertionError(f"{kernel}: {what}: max err {err}")
        cases[kernel] += 1

    for name, eng in _engines(dimension).items():
        spec = eng.spec
        rng = np.random.default_rng(12)
        secrets = eng.encode_secrets(
            rng.integers(0, min(eng.ctx.p, 1 << 62), size=(3 * P, dimension))
        )
        ext = torch.cat([secrets, eng.random_ext(3 * P, rng=rng)], dim=2)

        def plans(rows, rec=None, n_chunks=1):
            return [m8.mxu8_plan(eng.mxu8, spec.share_matrix, rows, P, spec.secret_count,
                                 spec.randomness_count, reconstruct_matrix=rec,
                                 device=device, n_chunks=n_chunks)
                    for device in (DEVICE, "cpu")]

        for mode, x in (("ext", ext), ("prng", secrets)):
            for n_chunks in (2, 3):
                sec8 = m8.planar8_from_batched(eng.mxu8, x[: n_chunks * P], LANES)
                rows = sec8.shape[0] // n_chunks
                for rec in (None, spec.reconstruct_matrix):
                    plan, plan_cpu = plans(rows, rec, n_chunks)
                    seed = 500 + sum(cases.values())
                    check("mxu8_chunked", m8.run_mxu8(plan, sec8, seed, lanes=LANES),
                          m8.run_mxu8(plan_cpu, sec8.cpu(), seed, lanes=LANES),
                          f"{name} {mode} n_chunks={n_chunks} rec={rec is not None}")
            # B3 onto a non-zero canonical running sum
            sec8 = m8.planar8_from_batched(eng.mxu8, x[: 2 * P], LANES)
            rows = sec8.shape[0] // 2
            plan, plan_cpu = plans(rows)
            acc = m8.run_mxu8(plan, sec8[:rows], 7)
            if not int(acc.count_nonzero()):
                raise AssertionError("the accumulator of the B3 check is zero")
            check("mxu8_acc", m8.run_mxu8(plan, sec8[rows:], 8, acc_in=acc.clone()),
                  m8.run_mxu8(plan_cpu, sec8[rows:].cpu(), 8, acc_in=acc.cpu().clone()),
                  f"{name} {mode}")
            if mode == "prng":
                # one chunked launch == the streaming loop at the same seed
                sec8 = m8.planar8_from_batched(eng.mxu8, x, LANES)
                rows = sec8.shape[0] // 3
                plan3, _ = plans(rows, None, 3)
                plan1, _ = plans(rows)
                seed, grid_t = 900, sec8.shape[1] // LANES
                chunked = m8.run_mxu8(plan3, sec8, seed, lanes=LANES)
                acc = m8.run_mxu8(plan1, sec8[:rows], seed)
                for c in (1, 2):
                    m8.run_mxu8(plan1, sec8[c * rows : (c + 1) * rows], seed + c * grid_t,
                                acc_in=acc)
                check("mxu8_chunked", chunked, acc, f"{name} chunked != streaming loop")
    return cases, max_err


def phase_headline(mhz: float, iters: int = 20):
    import torch

    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.ops import mxu8 as m8
    from sda_tpu_torch.utils.profiling import cuda_time
    from sda_tpu_torch.tools._common import (make_planar_secrets, mxu8_bound, mxu8_cost,
                                             reveal_check_slice)

    model = FederatedAggregation.packed_64bit(dimension=HEADLINE_DIM)
    engine = model.engine
    k, L8, L = engine.spec.secret_count, engine.mxu8.L8, engine.ctx.L
    nbp = -(-engine.nb // LANES) * LANES
    rows = HEADLINE_P * k * L8
    sec8 = make_planar_secrets(engine, 7, rows, nbp)
    torch.cuda.synchronize()

    # the main path: one aggregation step, counted
    _reset_counts()
    out = engine.aggregate_mxu8_kernel(sec8, 0, p_count=HEADLINE_P, lanes=LANES)
    torch.cuda.synchronize()
    counts = _counts()
    launches = counts["mxu8_fused"]
    if launches < 1:
        raise AssertionError(f"the headline step did not launch the mxu8 kernel: {counts}")
    if tuple(out.shape) != (engine.nb, k, L) or int(out.max()) > 0xFFFF or int(out.min()) < 0:
        raise AssertionError(f"headline output has shape {tuple(out.shape)} or limbs out of range")
    reveal_check_slice(engine, sec8, out, HEADLINE_P)

    # the plain version at the same shape, on the card, against the kernel
    plan = engine._plan("share", rows, HEADLINE_P, sec8.device)
    raw = m8.run_mxu8(plan, sec8, 0)
    t_plain = cuda_time(lambda i: m8._fused_share_combine_mxu8_plain(plan, sec8, 0), iters=1, warmup=0)
    plain = m8._fused_share_combine_mxu8_plain(plan, sec8, 0)
    err = int((raw.to(torch.int64) - plain.to(torch.int64)).abs().max())
    if err:
        raise AssertionError(f"headline kernel != plain version: max err {err}")

    t = cuda_time(
        lambda i: engine.aggregate_mxu8_kernel(sec8, i, p_count=HEADLINE_P, lanes=LANES),
        iters=iters, warmup=3,
    )
    # end to end: back-to-back steps on the host clock, one final sync
    t0 = time.perf_counter()
    for i in range(iters):
        engine.aggregate_mxu8_kernel(sec8, i, p_count=HEADLINE_P, lanes=LANES)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    # breakdown: the same launch with one randomness draw per slot instead
    # of 768 (the combined-draw mode) leaves the Philox stream 1/768 as long
    plan_rp1 = m8.mxu8_plan(
        engine.mxu8, engine.spec.share_matrix, rows, HEADLINE_P, k,
        engine.spec.randomness_count, reconstruct_matrix=engine.spec.reconstruct_matrix,
        rand_participants=1, device=DEVICE,
    )
    t_rp1 = cuda_time(lambda i: m8.run_mxu8(plan_rp1, sec8, i), iters=iters, warmup=3)
    cost = mxu8_cost(plan, nbp)
    bound_ms, bound_by, parts, call_ops = mxu8_bound(plan, nbp, mhz)
    philox_words = float(nbp) * plan.rp * plan.words_per_p
    return {
        "launches": launches, "timing": t, "plain_ms": t_plain.median_ms, "max_abs_err": err,
        "step_ms": step_ms, "rp1_ms": t_rp1.median_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "parts": parts, "philox_call_ops": call_ops,
        "launch": _launch_report(plan, nbp),
        "bytes": cost[0], "int8_ops": cost[1], "philox_words": philox_words,
        "shape": f"P={HEADLINE_P} dim={HEADLINE_DIM} rows={rows} NBP={nbp}",
    }


def _trace(fn, iters: int = 2):
    """``iters`` calls of ``fn`` under ``torch.profiler``
    (``profiling.profile_calls``, after an untraced call): (device busy ms a
    call, host wall ms a call, device activities by kernel name). Busy is
    the union of the device-side intervals (kernels, copies) in the trace
    (which holds some: ``profile_calls`` raises otherwise); wall is the host
    clock around the calls and a sync."""
    from sda_tpu_torch.utils.profiling import device_activities, kernel_name, profile_calls

    prof, seconds = profile_calls(lambda i: fn(), iters=iters)
    wall_ms = seconds * 1e3 / iters
    activities = device_activities(prof)
    spans = sorted((start, end) for _, start, end, _ in activities)
    names = collections.Counter(kernel_name(name) for name, *_ in activities)
    busy_us, (lo, hi) = 0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy_us += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return (busy_us + hi - lo) / 1e3 / iters, wall_ms, names


def phase_config3(mhz: float, iters: int = 20):
    """128-bit, 2 chunks x 512 participants in ONE B2 call (a memset, the
    split kernel and the epilogue kernel)."""
    import torch

    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.ops import mxu8 as m8
    from sda_tpu_torch.tools._common import make_planar_secrets, mxu8_bound, reveal_check_slice
    from sda_tpu_torch.utils.profiling import cuda_time, cuda_time_samples, device_breakdown

    c = CONFIG3
    engine = FederatedAggregation.packed_128bit(dimension=c["dimension"]).engine
    k, L8, L = engine.spec.secret_count, engine.mxu8.L8, engine.ctx.L
    lanes, n_chunks, p_chunk = c["lanes"], c["n_chunks"], c["p_chunk"]
    nbp = -(-engine.nb // lanes) * lanes
    rows = p_chunk * k * L8
    sec8 = torch.cat([make_planar_secrets(engine, 30 + i, rows, nbp) for i in range(n_chunks)])
    torch.cuda.synchronize()

    _reset_counts()
    out = engine.aggregate_mxu8_kernel_chunked(sec8, n_chunks, p_chunk, seed=1, lanes=lanes)
    torch.cuda.synchronize()
    counts = _counts()
    if counts != _only(mxu8_chunked=1):
        raise AssertionError(f"config 3 step launched {counts}, not one B2 call")
    if tuple(out.shape) != (engine.nb, k, L) or int(out.max()) > 0xFFFF or int(out.min()) < 0:
        raise AssertionError(f"config 3 output has shape {tuple(out.shape)} or limbs out of range")
    reveal_check_slice(engine, sec8, out, n_chunks * p_chunk, width=lanes, what="config 3")

    plan = engine._plan("share", rows, p_chunk, sec8.device, n_chunks)
    splits = m8.launch_splits(plan, nbp, sec8.device)
    lane_blocks = nbp // 128
    if lane_blocks * splits < SMS:
        raise AssertionError(f"config 3's B2 call launches {lane_blocks * splits} split blocks, "
                             f"fewer than the {SMS} SMs")
    raw = m8.run_mxu8(plan, sec8, 1, lanes=lanes)
    t_plain = cuda_time(
        lambda i: m8._fused_share_combine_mxu8_plain(plan, sec8, 1, nbp // lanes), iters=1, warmup=0
    )
    plain = m8._fused_share_combine_mxu8_plain(plan, sec8, 1, nbp // lanes)
    err = int((raw.to(torch.int64) - plain.to(torch.int64)).abs().max())
    if err:
        raise AssertionError(f"config 3 kernel != plain version: max err {err}")
    del plain
    t = cuda_time(
        lambda i: engine.aggregate_mxu8_kernel_chunked(sec8, n_chunks, p_chunk, seed=2 + i,
                                                       lanes=lanes),
        iters=iters, warmup=3,
    )
    # the card's own time for a step: windows of steps queued behind a
    # stream spin, so the host's submission of a call (three operations
    # now) is not in it
    t_dev = cuda_time_samples(
        lambda i: engine.aggregate_mxu8_kernel_chunked(sec8, n_chunks, p_chunk, seed=2 + i,
                                                       lanes=lanes),
        samples=5, iters=10,
    )
    bound_ms, bound_by, parts, call_ops = mxu8_bound(plan, nbp, mhz)

    # the call's kernels apart (torch.profiler), and the split kernel's two
    # halves through cut plans at the same S (CUDA events): the K tiles
    # without randomness, the draws behind one K tile per chunk, neither
    by_kernel = device_breakdown(lambda i: m8.run_mxu8(plan, sec8, i, lanes=lanes))
    one_tile = sec8.view(n_chunks, rows, nbp)[:, : m8.KT].reshape(-1, nbp).contiguous()
    no_rand = dataclasses.replace(plan, rp=0, Kr=0, words_per_p=0, n_bytes=0)
    cut = {"K tiles, no randomness": (no_rand, sec8),
           "draws, one tile a chunk": (dataclasses.replace(plan, rows=m8.KT), one_tile),
           "neither": (dataclasses.replace(no_rand, rows=m8.KT), one_tile)}
    phase_ms = {name: cuda_time(lambda i, q=q, x=x: m8.run_mxu8(q, x, i, lanes=lanes,
                                                              splits=splits),
                                iters=10, warmup=2).median_ms
                for name, (q, x) in cut.items()}
    # the whole call at other split counts
    sweep_ms = {s: cuda_time(lambda i, s=s: m8.run_mxu8(plan, sec8, i, lanes=lanes, splits=s),
                             iters=10, warmup=2).median_ms
                for s in sorted({1, max(1, splits - 1), splits, splits + 1, 2 * splits})}
    del sec8, raw, one_tile
    torch.cuda.empty_cache()
    return {
        "launches": counts["mxu8_chunked"], "timing": t, "device_timing": t_dev,
        "plain_ms": t_plain.median_ms,
        "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by, "parts": parts,
        "philox_call_ops": call_ops, "launch": _launch_report(plan, nbp),
        "epilogue_launch": _launch_report(plan, nbp, epilogue=True),
        "splits": splits, "lane_blocks": lane_blocks, "grid_blocks": lane_blocks * splits,
        "by_kernel_ms": by_kernel, "phase_ms": phase_ms, "sweep_ms": sweep_ms,
        "shape": f"P={n_chunks}x{p_chunk} dim={c['dimension']} 128-bit rows={rows}/chunk "
                 f"NBP={nbp} lanes={lanes}",
    }


def _b2_kernels(by_kernel) -> dict:
    """The profiler's per-call device times of B2's memset and kernels."""
    names = {"split kernel": "mxu8_split_kernel", "epilogue kernel": "mxu8_epilogue_kernel",
             "memset": "Memset"}
    return {label: by_kernel.get(key, 0.0) for label, key in names.items()}


def _by_kernel_text(by_kernel) -> str:
    return ", ".join(f"{label} {ms:.4f} ms" for label, ms in _b2_kernels(by_kernel).items())


def phase_config4(mhz: float, iters: int = 5):
    """10,752 participants x 1,000,002 dimensions streamed in 14 chunks:
    B1 for the first chunk, B3 for the other 13, B1 for the reconstruction."""
    import torch

    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.ops import mxu8 as m8
    from sda_tpu_torch.utils.profiling import cuda_time
    from sda_tpu_torch.tools._common import (bound, make_planar_secrets, mxu8_bound, mxu8_cost,
                                             reveal_check_slice)

    c = CONFIG4
    engine = FederatedAggregation.packed_64bit(dimension=HEADLINE_DIM).engine
    k, L8, L = engine.spec.secret_count, engine.mxu8.L8, engine.ctx.L
    p_chunk, n_chunks = c["p_chunk"], c["n_chunks"]
    nbp = -(-engine.nb // LANES) * LANES
    rows = p_chunk * k * L8
    chunk = make_planar_secrets(engine, 40, rows, nbp)  # resident, re-read per chunk
    torch.cuda.synchronize()

    def step(seed0):
        return engine.aggregate_mxu8_kernel_streaming([lambda i: chunk] * n_chunks, p_chunk,
                                                      seed0=seed0, lanes=LANES)

    _reset_counts()
    out = step(1)
    torch.cuda.synchronize()
    counts = _counts()
    if counts != _only(mxu8_fused=2, mxu8_acc=n_chunks - 1):
        raise AssertionError(f"config 4 step launched {counts}, not B1 x 2 and B3 x 13")
    if tuple(out.shape) != (engine.nb, k, L) or int(out.max()) > 0xFFFF or int(out.min()) < 0:
        raise AssertionError(f"config 4 output has shape {tuple(out.shape)} or limbs out of range")
    reveal_check_slice(engine, chunk, out, p_chunk, times=n_chunks, what="config 4")

    # one B3 launch against its plain version on the card, onto a canonical
    # running sum
    plan = engine._plan("combine", rows, p_chunk, chunk.device)
    acc0 = engine.mxu8_kernel_combined(chunk, 3, p_chunk, LANES)
    got = m8.run_mxu8(plan, chunk, 4, acc_in=acc0.clone())
    t_plain = cuda_time(
        lambda i: m8._fused_share_combine_mxu8_plain(plan, chunk, 4, acc_in=acc0.clone()),
        iters=1, warmup=0,
    )
    want = m8._fused_share_combine_mxu8_plain(plan, chunk, 4, acc_in=acc0.clone())
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err:
        raise AssertionError(f"config 4 B3 kernel != plain version: max err {err}")

    acc = acc0.clone()
    t_acc = cuda_time(lambda i: m8.run_mxu8(plan, chunk, 10 + i, acc_in=acc), iters=10, warmup=2)
    t_first = cuda_time(lambda i: engine.mxu8_kernel_combined(chunk, 30 + i, p_chunk, LANES),
                        iters=5, warmup=1)
    t_rec = cuda_time(lambda i: engine.reconstruct_planar8(acc0, LANES), iters=10, warmup=2)
    t_step = cuda_time(lambda i: step(100 + i * n_chunks), iters=iters, warmup=1)
    t0 = time.perf_counter()
    for i in range(iters):
        step(1000 + i * n_chunks)
    torch.cuda.synchronize()
    host_step_ms = (time.perf_counter() - t0) / iters * 1e3
    kernel_sum_ms = t_first.median_ms + (n_chunks - 1) * t_acc.median_ms + t_rec.median_ms
    busy_ms, traced_wall_ms, names = _trace(lambda: step(5000))
    activities = sum(names.values()) // 2
    if names["mxu8_fused_kernel"] != 2 * (n_chunks + 1):
        raise AssertionError(f"two traced config-4 steps recorded {names['mxu8_fused_kernel']} "
                             f"B1/B3 launches, not {2 * (n_chunks + 1)}")

    rec_plan = engine._plan("reconstruct", engine.spec.share_count * L8, 1, chunk.device)
    acc_cost = mxu8_cost(plan, nbp, acc=True)
    step_costs = [mxu8_cost(plan, nbp)] + [acc_cost] * (n_chunks - 1) + [mxu8_cost(rec_plan, nbp)]
    step_bound_ms, step_bound_by = bound(step_costs)
    bound_ms, bound_by, parts, call_ops = mxu8_bound(plan, nbp, mhz, acc=True)
    return {
        "launches": counts["mxu8_acc"], "fused_launches": counts["mxu8_fused"], "timing": t_acc,
        "plain_ms": t_plain.median_ms, "max_abs_err": err,
        "bound_ms": bound_ms, "bound_by": bound_by, "parts": parts, "philox_call_ops": call_ops,
        "launch": _launch_report(plan, nbp, acc=True),
        "step": t_step, "host_step_ms": host_step_ms, "kernel_sum_ms": kernel_sum_ms,
        "first_ms": t_first.median_ms, "rec_ms": t_rec.median_ms,
        "idle_share": max(0.0, 1 - kernel_sum_ms / host_step_ms),
        "traced_busy_ms": busy_ms, "traced_wall_ms": traced_wall_ms,
        "traced_activities": activities,
        "traced_idle_share": 1 - busy_ms / traced_wall_ms,
        "step_bound_ms": step_bound_ms, "step_bound_by": step_bound_by,
        "step_bytes": sum(b for b, _ in step_costs),
        "shape": f"P={n_chunks}x{p_chunk} dim={HEADLINE_DIM} rows={rows}/chunk NBP={nbp}",
    }


def phase_wide(iters: int = 10):
    """``WIDE``: mode 3 of ``csrc/mxu8.cu`` at the 728-clerk committee's
    widths, then three small cases beside them. Each launch is held bit-equal to the plain version on the card
    at full width and on the CPU at ``cpu_lanes`` lanes, its launches
    counted, then timed with CUDA events, the counters reset just before.
    Bounds: the implemented work (``mxu8_cost``: the padded contraction and
    every operand byte) and the share's work from shapes alone (each batch
    of k secrets meets each clerk's column byte by byte, ``P * nb * k * n *
    ceil(20 / 8)^2`` int8 multiply-adds; the elements read once at 4 bytes
    and the clerks' sums written once)."""
    import numpy as np
    import torch

    from sda_tpu_torch import engine as engine_mod
    from sda_tpu_torch.engine import TorchAggregationEngine
    from sda_tpu_torch.fields import find_special_prime_field
    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.ops import mxu8 as m8
    from sda_tpu_torch.sharing import AdditiveScheme
    from sda_tpu_torch.tools._common import bound, mxu8_cost
    from sda_tpu_torch.utils.profiling import cuda_time

    eng = FederatedAggregation.packed_tss728(dimension=WIDE["dimension"], device=DEVICE).engine
    spec, L, L8, lanes = eng.spec, eng.ctx.L, eng.mxu8.L8, WIDE["lanes"]
    k, r, n = spec.secret_count, spec.randomness_count, spec.share_count
    nbp, cpu_nbp = -(-eng.nb // lanes) * lanes, WIDE["cpu_lanes"]
    card, cpu = torch.device(DEVICE), torch.device("cpu")
    gen = torch.Generator(device=DEVICE).manual_seed(WIDE["seed"])
    field_bytes = -(-spec.modulus.bit_length() // 8)

    def check(what, got, want):
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"wide {what}: kernel != plain version, max err "
                                 f"{_max_err(got, want)}")

    def counted(what, launches):
        if _counts() != _only(mxu8_wide=launches):
            raise AssertionError(f"wide {what} launched {_counts()}, not mxu8_wide x {launches}")

    def timed(what, fn):
        _reset_counts()
        t = cuda_time(fn, iters=iters, warmup=2)
        counted(what, iters + 2)
        return t

    res = {"shape": f"n={n} k={k} t={r} p={spec.modulus} d={WIDE['dimension']} NBP={nbp}"}
    comb = None
    for mode, P, prng in (("prng", WIDE["prng_participants"], True),
                          ("caller", WIDE["caller_participants"], False)):
        rows = P * (k if prng else k + r) * L8
        plan, cpu_plan = (eng._plan("combine", rows, P, d) for d in (card, cpu))
        if not m8.is_wide(plan):
            raise AssertionError(f"the {mode} plan ({plan.n * L8 + 1} rows) is not wide")
        secs = [torch.randint(-128, 128, (rows, nbp), generator=gen, dtype=torch.int8,
                              device=DEVICE) for _ in range(2)]
        _reset_counts()
        b1 = m8.run_mxu8(plan, secs[0], seed=11)
        b3 = m8.run_mxu8(plan, secs[1], seed=12, acc_in=b1.clone())
        torch.cuda.synchronize()
        counted(f"{mode} B1 + B3", 2)
        want = m8._fused_share_combine_mxu8_plain(plan, secs[0], 11)
        check(f"{mode} B1", b1, want)
        check(f"{mode} B3", b3, m8._fused_share_combine_mxu8_plain(plan, secs[1], 12,
                                                                    acc_in=want))
        small = [x[:, :cpu_nbp].contiguous() for x in secs]
        got = m8.run_mxu8(plan, small[0], seed=11)
        want = m8.run_mxu8(cpu_plan, small[0].cpu(), seed=11)
        check(f"{mode} B1 at {cpu_nbp} lanes against the CPU", got, want)
        got = m8.run_mxu8(plan, small[1], seed=12, acc_in=got)
        check(f"{mode} B3 at {cpu_nbp} lanes against the CPU", got,
              m8.run_mxu8(cpu_plan, small[1].cpu(), seed=12, acc_in=want))
        acc = b3.clone()
        t1 = timed(f"{mode} B1", lambda i: m8.run_mxu8(plan, secs[0], seed=i))
        t3 = timed(f"{mode} B3", lambda i: m8.run_mxu8(plan, secs[1], seed=i, acc_in=acc))
        macs = P * eng.nb * k * n * field_bytes ** 2
        shape_bytes = 4 * (P * WIDE["dimension"] + L * n * nbp)
        res[mode] = {"P": P, "rows": rows, "Kr": plan.Kr, "b1": t1, "b3": t3,
                     "launches": iters + 2,
                     "bound": bound([mxu8_cost(plan, nbp)]),
                     "bound_b3": bound([mxu8_cost(plan, nbp, acc=True)]),
                     "shape_bound": bound([(shape_bytes, 2.0 * macs)])}
        if prng:
            comb = b3

    clerks = sorted(np.random.default_rng(WIDE["seed"]).choice(n, WIDE["clerks"], replace=False)
                    .tolist())
    before = engine_mod.subset_reconstruct_launches
    _reset_counts()
    sub = eng.reconstruct_lm(comb, lanes, clerks)
    full = eng.reconstruct_lm(comb, lanes)
    torch.cuda.synchronize()
    counted("the subset and the full-set reconstruction", 2)
    if engine_mod.subset_reconstruct_launches != before + 1:
        raise AssertionError("the subset reconstruction was not counted once")
    check(f"reconstruction from {len(clerks)} clerks against all {n}", sub, full)
    plan = eng.subset_plan(tuple(clerks), card)
    rows = torch.tensor([l * n + i for l in range(L) for i in clerks], device=card)
    c8 = eng._clerk_bytes(comb.index_select(0, rows), len(clerks))
    check("reconstruction", sub, m8._fused_share_combine_mxu8_plain(plan, c8, 0))
    check(f"reconstruction at {cpu_nbp} lanes against the CPU", sub[:, :cpu_nbp],
          eng.reconstruct_lm(comb[:, :cpu_nbp].cpu(), lanes, clerks))
    t_rec = timed("reconstruction kernel", lambda i: m8.run_mxu8(plan, c8, 0))
    t_call = timed("reconstruction call", lambda i: eng.reconstruct_lm(comb, lanes, clerks))
    # a subset not seen before: its Lagrange matrix and plan, on the host
    other = tuple(sorted(np.random.default_rng(WIDE["seed"] + 1)
                         .choice(n, WIDE["clerks"], replace=False).tolist()))
    t0 = time.perf_counter()
    eng.subset_plan(other, card)
    torch.cuda.synchronize()
    res["rec"] = {"clerks": len(clerks), "rows": plan.rows, "kernel": t_rec, "call": t_call,
                  "bound": bound([mxu8_cost(plan, nbp)]),
                  "plan_ms": (time.perf_counter() - t0) * 1e3}

    # beside the committee's widths, against the CPU: a lane count that is no
    # multiple of 128, and the narrowest wide plan (25 additive clerks at
    # 2^63 - 871: 201 output rows, the pseudo-Mersenne fold) in both modes
    p63 = find_special_prime_field(63, 8, 9)[0]
    add = TorchAggregationEngine(AdditiveScheme(share_count=25, modulus=p63).device_spec(), 300,
                                 device=DEVICE)
    for e, P, prng, width in ((eng, 3, True, 200), (add, 3, True, 384), (add, 3, False, 384)):
        slots = e.spec.secret_count + (0 if prng else e.spec.randomness_count)
        rows = P * slots * e.mxu8.L8
        plan, cpu_plan = (e._plan("combine", rows, P, d) for d in (card, cpu))
        if not m8.is_wide(plan):
            raise AssertionError(f"the {plan.n}-clerk plan is not wide")
        x = torch.randint(-128, 128, (rows, width), generator=gen, dtype=torch.int8,
                          device=DEVICE)
        check(f"{plan.n} clerks, P={P}, {width} lanes", m8.run_mxu8(plan, x, seed=5),
              m8.run_mxu8(cpu_plan, x.cpu(), seed=5))
    return res


def _wide_lines(w: dict, card: str) -> list[str]:
    lines = [f"wide: {w['shape']} on {card}: mode 3 B1 and B3 bit-equal to the plain version "
             f"(on the card at full width, on the CPU at {WIDE['cpu_lanes']} lanes) with the "
             f"kernel's randomness (P={w['prng']['P']}) and the caller's (P={w['caller']['P']}); "
             f"the reconstruction from {w['rec']['clerks']} clerks equal to the full-set one and "
             f"to the plain version; at 200 lanes, and 25 additive clerks at 2^63 - 871 (201 "
             f"rows) in both modes, equal to the CPU"]
    for mode in ("prng", "caller"):
        m = w[mode]
        lines.append(
            f"wide: {mode} P={m['P']} ({m['rows']} operand rows, Kr {m['Kr']}): B1 median "
            f"{m['b1'].median_ms:.4f} ms (min {m['b1'].min_ms:.4f}, max {m['b1'].max_ms:.4f}), "
            f"B3 median {m['b3'].median_ms:.4f} ms (min {m['b3'].min_ms:.4f}, max "
            f"{m['b3'].max_ms:.4f}), {len(m['b1'].samples_ms)} launches each, events; bound "
            f"{m['bound'][0]:.4f} ms ({m['bound'][1]}, the implemented work; B3 "
            f"{m['bound_b3'][0]:.4f}), from shapes {m['shape_bound'][0]:.4f} ms "
            f"({m['shape_bound'][1]}): {m['shape_bound'][0] / m['b1'].median_ms:.4f} of it")
    rc = w["rec"]
    lines.append(
        f"wide: reconstruction from {rc['clerks']} clerks ({rc['rows']} rows): kernel median "
        f"{rc['kernel'].median_ms:.4f} ms (min {rc['kernel'].min_ms:.4f}, max "
        f"{rc['kernel'].max_ms:.4f}), bound {rc['bound'][0]:.4f} ms ({rc['bound'][1]}); "
        f"reconstruct_lm (rows gathered, bytes split, the launch) median "
        f"{rc['call'].median_ms:.4f} ms; a new subset's Lagrange matrix and plan "
        f"{rc['plan_ms']:.1f} ms on the host clock")
    return lines


def phase_serving(mhz: float, iters: int = 20):
    """512 small jobs side by side on the lane axis, one B1 launch, in both
    randomness modes."""
    import torch

    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.ops import mxu8 as m8
    from sda_tpu_torch.utils.profiling import cuda_time
    from sda_tpu_torch.tools._common import make_planar_secrets, mxu8_bound, reveal_check_slice

    c = SERVING
    engine = FederatedAggregation.packed_64bit(dimension=c["dimension"]).engine
    k, L8, L = engine.spec.secret_count, engine.mxu8.L8, engine.ctx.L
    P, n_jobs, job_lanes = c["participants"], c["jobs"], c["job_lanes"]
    rows = P * k * L8
    jobs = list(make_planar_secrets(engine, 50, rows, n_jobs * job_lanes).split(job_lanes, dim=1))
    batched = engine.concat_jobs_lanes(jobs)
    nbp = batched.shape[1]
    torch.cuda.synchronize()
    res = {}
    for combined in (False, True):
        _reset_counts()
        outs = engine.aggregate_mxu8_kernel_jobs(batched, 0, P, n_jobs, lanes=LANES,
                                                 combined_randomness=combined)
        torch.cuda.synchronize()
        counts = _counts()
        if counts != _only(mxu8_fused=1):
            raise AssertionError(f"serving (combined={combined}) launched {counts}, not one B1")
        if tuple(outs.shape) != (n_jobs, engine.nb, k, L):
            raise AssertionError(f"serving output has shape {tuple(outs.shape)}")
        for j in (0, 1, n_jobs - 1):
            reveal_check_slice(engine, jobs[j], outs[j], P, width=engine.nb,
                               what=f"serving job {j}")
        plan = engine._plan("share", rows, P, batched.device,
                            rand_participants=1 if combined else None)
        err = int((m8.run_mxu8(plan, batched, 5).to(torch.int64)
                   - m8._fused_share_combine_mxu8_plain(plan, batched, 5).to(torch.int64))
                  .abs().max())
        if err:
            raise AssertionError(f"serving kernel != plain version: max err {err}")
        t = cuda_time(
            lambda i: engine.aggregate_mxu8_kernel_jobs(batched, i, P, n_jobs, lanes=LANES,
                                                        combined_randomness=combined),
            iters=iters, warmup=3,
        )
        bound_ms, bound_by, parts, _ = mxu8_bound(plan, nbp, mhz)
        res[combined] = {"launches": counts["mxu8_fused"], "timing": t, "max_abs_err": err,
                         "bound_ms": bound_ms, "bound_by": bound_by, "parts": parts}
    res["shape"] = f"{n_jobs} jobs x P={P} dim={c['dimension']} NBP={nbp}"
    return res


def phase_forward(participants: int = 32):
    import numpy as np
    import torch

    from sda_tpu_torch.models import FederatedAggregation

    model = FederatedAggregation.packed_64bit(dimension=HEADLINE_DIM)
    secrets, gen = model.example_inputs(participants=participants, seed=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.forward(secrets, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    revealed = model.reveal(out)
    raw = np.random.default_rng(3).integers(
        0, min(model.scheme_modulus, 1 << 31), size=(participants, HEADLINE_DIM)
    )
    expect = raw.sum(axis=0) % model.scheme_modulus
    if not np.array_equal(revealed.astype(np.int64), expect):
        raise AssertionError("CIOS forward reveal != numpy sum mod p")
    return seconds


def _host_fold(seeds, dimension: int, modulus: int):
    """The port's host oracle: the exact expansion of every seed, folded
    with ``trunc_add_mod`` (what ``ChaChaMasker`` does on the host route)."""
    import numpy as np

    from sda_tpu_torch import chacha
    from sda_tpu_torch.fields import trunc_add_mod

    acc = np.zeros(dimension, dtype=np.int64)
    for row in chacha.expand_masks(seeds, dimension, modulus):
        acc = trunc_add_mod(acc, row, modulus)
    return acc


def _chacha_bound(ops: float, nbytes: float, mhz: float):
    """(bound ms, "operations" | "bytes", ms at the 64 INT32 lanes alone):
    the larger of the 32-bit operations over the SMs' issue rate at the
    maximum SM clock and the bytes over the HBM rate."""
    ops_ms = ops / (SMS * ISSUE_LANES * mhz * 1e6) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    int32_only_ms = ops / (SMS * INT32_LANES * mhz * 1e6) * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", int32_only_ms


def phase_compare_chacha():
    """B4 and B5 on the card against their plain versions on CPU copies of
    the same inputs, bit-equal; the grouping and the forced-rejection fix-up
    through ``combine_masks_device``. Returns case counts, max errors, and
    the mid-shape times (kernel and plain version on the card)."""
    from unittest import mock

    import numpy as np
    import torch

    from sda_tpu_torch import chacha
    from sda_tpu_torch.fields import find_prime_field, find_special_prime_field
    from sda_tpu_torch.ops import chacha_kernel as ck
    from sda_tpu_torch.utils.profiling import cuda_time

    cases = {"chacha_keystream": 0, "chacha_fold": 0, "expand": 0}
    max_err = {"chacha_keystream": 0, "chacha_fold": 0}

    def check(kernel, got, want, what):
        err = int((got.cpu().to(torch.int64) - want.cpu().to(torch.int64)).abs().max())
        if kernel in max_err:
            max_err[kernel] = max(max_err[kernel], err)
        if err:
            raise AssertionError(f"{kernel}: {what}: max err {err}")
        cases[kernel] += 1

    rng = np.random.default_rng(60)
    seeds = [chacha.new_seed(128, rng) for _ in range(1100)]
    cpu = torch.device("cpu")

    # B4: the RFC zero-seed vector and a ragged block count
    zero = ck.chacha_keystream(np.zeros((1, 8), np.uint32), 1, device=DEVICE)
    if (zero[0, 0, :4].cpu().to(torch.int64) & 0xFFFFFFFF).tolist() != [
            0xADE0B876, 0x903DF1A0, 0xE56A5D40, 0x28BD8653]:
        raise AssertionError("B4 misses the RFC zero-seed vector")
    check("chacha_keystream", zero, ck.chacha_keystream(np.zeros((1, 8), np.uint32), 1,
                                                        device="cpu"), "zero seed")
    keys = ck._key_tensor(seeds[:300], torch.device(DEVICE))
    check("chacha_keystream", ck.chacha_keystream(seeds[:300], 257, device=DEVICE),
          ck._keystream_plain(keys.cpu(), 257), "300 seeds x 257 blocks")
    mid4 = {
        "kernel": cuda_time(lambda i: ck._launch_keystream(keys, 257), iters=10, warmup=2),
        "plain": cuda_time(lambda i: ck._keystream_plain(keys, 257), iters=1, warmup=1),
        "shape": "S=300 nblocks=257",
    }

    # the chunk route's expansion (B4 + the torch reduction) at four moduli
    for modulus in (433, (1 << 31) - 1, (1 << 61) - 1, find_prime_field(62, 8, 9)[0]):
        m_dev, r_dev = ck.expand_masks_device(seeds[:64], 1000, modulus, device=DEVICE)
        m_cpu, r_cpu = ck.expand_masks_device(seeds[:64], 1000, modulus, device="cpu")
        check("expand", m_dev, m_cpu, f"expand masks p={modulus}")
        check("expand", r_dev, r_cpu, f"expand rejection counts p={modulus}")

    # B5 at e = 63 and e = 55 (the carry*K product that once wrapped)
    mid5 = None
    for e in (63, 55):
        p = find_special_prime_field(e, 8, 9)[0]
        limbs, rej = ck.fold_masks_device(seeds, 264, p, device=DEVICE)
        t0 = time.perf_counter()
        want, want_rej = ck.fold_masks_device(seeds, 264, p, device="cpu")
        plain_cpu_s = time.perf_counter() - t0
        check("chacha_fold", limbs, want, f"fold e={e} limbs")
        check("chacha_fold", torch.from_numpy(rej), torch.from_numpy(want_rej),
              f"fold e={e} rejection counts")
        la = limbs.cpu().numpy().astype(np.int64)
        got = la[:, 0] | (la[:, 1] << 16) | (la[:, 2] << 32) | (la[:, 3] << 48)
        if got.tolist() != _host_fold(seeds, 264, p).tolist():
            raise AssertionError(f"B5 at e={e} != the host oracle fold")
        if e == 63:
            fkeys = ck._key_tensor(seeds, torch.device(DEVICE))
            mid5 = {
                "kernel": cuda_time(lambda i: ck._launch_fold(fkeys, 264, p), iters=10, warmup=2),
                "plain": cuda_time(lambda i: ck._fold_plain(fkeys, 264, p), iters=1, warmup=1),
                "plain_cpu_ms": plain_cpu_s * 1e3, "shape": "S=1100 d=264",
            }

    # B5's rejection path with hits: the zone lowered to draws >= 2^62
    # (hi >= 2^30). The limbs do not depend on the zone; the per-seed counts
    # must equal the plain version's, and the fused route's host fix-up of
    # every seed that hit (a no-op at this modulus) must stay exact
    p63 = find_special_prime_field(63, 8, 9)[0]
    with mock.patch.object(ck, "_zone", lambda modulus: (0x40000000, 0)):
        limbs, rej = ck.fold_masks_device(seeds, 264, p63, device=DEVICE)
        want, want_rej = ck.fold_masks_device(seeds, 264, p63, device="cpu")
        check("chacha_fold", limbs, want, "lowered zone limbs")
        check("chacha_fold", torch.from_numpy(rej), torch.from_numpy(want_rej),
              "lowered zone rejection counts")
        out, hit = ck.combine_masks_device(seeds[:600], 48, p63, device=DEVICE)
    zone_hits = int(want_rej.sum())
    if int(want_rej.min()) == 0 or len(hit) != 600:
        raise AssertionError(f"the lowered zone missed seeds ({len(hit)} of 600 hit)")
    if out.tolist() != _host_fold(seeds[:600], 48, p63).tolist():
        raise AssertionError("the fused route's host fix-up is not exact")
    cases["chacha_fold"] += 1

    # grouping: 16,500 seeds are two B5 launches (16,384 + 116)
    many = [chacha.new_seed(128, rng) for _ in range(16_500)]
    _reset_counts()
    out, bad = ck.combine_masks_device(many, 16, p63, device=DEVICE)
    if _chacha_counts() != {"chacha_keystream": 0, "chacha_fold": 2}:
        raise AssertionError(f"grouping launched {_chacha_counts()}, not 2 B5 launches")
    if bad or out.tolist() != _host_fold(many, 16, p63).tolist():
        raise AssertionError(f"grouping != the host oracle (bad {bad})")
    cases["chacha_fold"] += 1

    # forced rejections (2^62 + 1: ~1/4 of the draws): the fix-up is exact
    forced = (1 << 62) + 1
    _, bad = ck.combine_masks_device(seeds[:6], 48, forced, fixup_host=False, device=DEVICE)
    if not bad:
        raise AssertionError("2^62 + 1 was supposed to force rejections")
    out, bad2 = ck.combine_masks_device(seeds[:6], 48, forced, device=DEVICE)
    if bad2 != bad or [int(x) for x in out] != _host_fold(seeds[:6], 48, forced).tolist():
        raise AssertionError("the forced-rejection fix-up is not exact")
    cases["chacha_keystream"] += 1
    return {"cases": cases, "max_err": max_err, "mid4": mid4, "mid5": mid5,
            "forced_bad": len(bad), "zone_hits": zone_hits}


def _window_oracle(seeds, dimension: int, modulus: int, bad, dims):
    """The fold of every seed's exact mask on the dimensions ``dims``: the
    port's ``chacha_core_blocks`` on just the block counters that hold
    them, each draw ``v mod p``, folded with ``trunc_add_mod``; a seed in
    ``bad`` takes its exact (rejection-skipping) host expansion instead."""
    import numpy as np

    from sda_tpu_torch import chacha
    from sda_tpu_torch.fields import trunc_add_mod

    counters = np.unique(dims // 8)
    keys = np.zeros((len(seeds), 8), dtype=np.uint32)
    for i, w in enumerate(seeds):
        keys[i, : len(w)] = w
    states = np.zeros((len(seeds), len(counters), 16), dtype=np.uint32)
    states[:, :, :4] = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
    states[:, :, 4:12] = keys[:, None, :]
    states[:, :, 12] = counters.astype(np.uint32)[None, :]
    words = chacha.chacha_core_blocks(states).reshape(len(seeds), len(counters), 8, 2)
    draws = (words[..., 0].astype(np.uint64) << np.uint64(32)) | words[..., 1].astype(np.uint64)
    pos = np.searchsorted(counters, dims // 8) * 8 + dims % 8
    vals = (draws.reshape(len(seeds), -1)[:, pos] % np.uint64(modulus)).astype(np.int64)
    for i in bad:
        vals[i] = chacha.expand_masks([seeds[i]], dimension, modulus)[0][dims]
    acc = np.zeros(len(dims), dtype=np.int64)
    for row in vals:
        acc = trunc_add_mod(acc, row, modulus)
    return acc


def _windows(dimension: int):
    import numpy as np

    c = CHACHA
    counters = np.arange(c["stride"], dimension // 8, c["stride"])
    strided = (counters[:, None] * 8 + np.arange(8)).reshape(-1)
    return np.unique(np.concatenate([np.arange(c["window"]), strided,
                                     np.arange(dimension - c["tail"], dimension)]))


def phase_chacha_reveal(mhz: float, iters: int = 5):
    """10,000 seeds x 1,000,002 dimensions through ChaChaMasker's forced
    device route: one B5 launch per combine, exact on both windows."""
    import numpy as np
    import torch

    from sda_tpu_torch import chacha
    from sda_tpu_torch.fields import find_special_prime_field
    from sda_tpu_torch.masking import ChaChaMasker
    from sda_tpu_torch.ops import chacha_kernel as ck
    from sda_tpu_torch.routing import RoutingPolicy
    from sda_tpu_torch.utils.profiling import cuda_time

    S, D = CHACHA["seeds"], CHACHA["dimension"]
    p = find_special_prime_field(63, 8, 9)[0]
    before = dict(chacha.expansions)
    rng = np.random.default_rng(70)
    seeds = [chacha.new_seed(128, rng) for _ in range(S)]
    seeds_i64 = [np.array(w, dtype=np.int64) for w in seeds]
    masker = ChaChaMasker(p, D, 128, routing=RoutingPolicy.force("device"), device=DEVICE)
    torch.cuda.synchronize()

    # the main path: one combine, counted
    _reset_counts()
    t0 = time.perf_counter()
    combined = masker.combine(seeds_i64)
    first_s = time.perf_counter() - t0
    counts = _chacha_counts()
    if counts != {"chacha_keystream": 0, "chacha_fold": 1}:
        raise AssertionError(f"the chacha reveal launched {counts}, not one B5 launch")
    if combined.shape != (D,) or combined.dtype != np.int64 or not (
            int(combined.min()) >= 0 and int(combined.max()) < p):
        raise AssertionError("the chacha reveal is not D canonical int64 values")

    # the same launch alone: its rejection counts and its limbs
    keys = ck._key_tensor(seeds, torch.device(DEVICE))
    limbs, rej = ck._launch_fold(keys, D, p)
    bad = [int(i) for i in torch.nonzero(rej).flatten().tolist()]
    dims = _windows(D)
    want = _window_oracle(seeds, D, p, bad, dims)
    if combined[dims].tolist() != want.tolist():
        raise AssertionError("the chacha reveal != the numpy oracle on its windows")
    checked = len(dims)
    if not bad:
        la = limbs.cpu().numpy().astype(np.int64)
        raw = la[:, 0] | (la[:, 1] << 16) | (la[:, 2] << 32) | (la[:, 3] << 48)
        if not np.array_equal(raw, combined):
            raise AssertionError("a second B5 launch differs from the combine's")

    t = cuda_time(lambda i: ck._launch_fold(keys, D, p), iters=iters, warmup=1)
    host = []
    default = ChaChaMasker(p, D, 128)  # every default: the device route on the card
    for _ in range(3):
        _reset_counts()
        t0 = time.perf_counter()
        default.combine(seeds_i64)
        host.append(time.perf_counter() - t0)
        if _chacha_counts() != counts:
            raise AssertionError(f"a timed combine launched {_chacha_counts()}")
    nb = -(-D // 8)
    ops = float(S) * nb * (CHACHA_BLOCK_OPS + FOLD_DRAW_OPS)
    nbytes = S * 32 + D * 16 + S * 4
    bound_ms, bound_by, int32_only_ms = _chacha_bound(ops, nbytes, mhz)
    return {
        "launches": counts["chacha_fold"], "timing": t, "bad": len(bad), "checked": checked,
        "host_ms": sorted(h * 1e3 for h in host), "first_host_ms": first_s * 1e3,
        "bound_ms": bound_ms, "bound_by": bound_by, "int32_only_ms": int32_only_ms,
        "ops": ops, "bytes": nbytes, "shape": f"S={S} d={D} p=2^63-871",
        "expansions": {name: n - before[name] for name, n in chacha.expansions.items()},
    }


def _host_recombine_combine(seed_words, dimension: int, modulus: int):
    """The fused route with the host recombine it had before the recombine
    moved to the card: each group's ``[d, 4]`` limbs copied to the host,
    widened to int64, shifted and ORed, the groups folded with
    ``trunc_add_mod``, then the rejected seeds' fix-up in python ints."""
    import numpy as np

    from sda_tpu_torch import chacha
    from sda_tpu_torch.fields import trunc_add_mod
    from sda_tpu_torch.ops import chacha_kernel as ck

    out, bad = None, []
    for start in range(0, len(seed_words), ck._FOLD_SEED_CAP):
        limbs, rej = ck.fold_masks_device(seed_words[start : start + ck._FOLD_SEED_CAP],
                                          dimension, modulus, device=DEVICE)
        bad.extend(start + int(i) for i in np.nonzero(rej)[0])
        la = limbs.cpu().numpy().astype(np.int64)
        part = la[:, 0] | (la[:, 1] << 16) | (la[:, 2] << 32) | (la[:, 3] << 48)
        out = part if out is None else trunc_add_mod(out, part, modulus)
    if bad:
        seeds = [seed_words[i] for i in bad]
        wrong = chacha.expand_masks_noskip(seeds, dimension, modulus)
        exact = chacha.expand_masks(seeds, dimension, modulus)
        o = np.array(out.tolist(), dtype=object)
        for j in range(len(bad)):
            o = (o - np.array(wrong[j].tolist(), dtype=object)
                 + np.array(exact[j].tolist(), dtype=object)) % modulus
        out = o.astype(np.int64)
    return out, bad


def phase_fused_recombine(iters: int = 5, dimension: int = 1 << 20):
    """The fused combine's host tail at a federated round's size (2^20
    dimensions): 16,384 seeds (one B5 group) and 16,385 (two groups, the
    host fold), the second with the first seed of each group marked
    rejected and its exact mask traded for another, each bit-equal to
    :func:`_host_recombine_combine` and exact on the windows; then, on the
    host clock, the combine and the tail alone by either recombine, and
    the unmask's subtract by either route of ``trunc_sub_mod``."""
    from unittest import mock

    import numpy as np
    import torch

    from sda_tpu_torch import chacha
    from sda_tpu_torch import fields
    from sda_tpu_torch.fields import find_special_prime_field, trunc_add_mod
    from sda_tpu_torch.ops import chacha_kernel as ck
    from sda_tpu_torch.ops.limbs import LimbContext

    D, S = dimension, ck._FOLD_SEED_CAP
    p = find_special_prime_field(63, 8, 9)[0]
    rng = np.random.default_rng(75)
    seeds = [chacha.new_seed(128, rng) for _ in range(S + 1)]
    dims = _windows(D)

    ck.fold_recombine_device_launches = 0
    _reset_counts()
    one, bad = ck.combine_masks_device(seeds[:S], D, p, device=DEVICE)
    counts = {**_chacha_counts(), "fold_recombine_device": ck.fold_recombine_device_launches}
    if counts != {"chacha_keystream": 0, "chacha_fold": 1, "fold_recombine_device": 1}:
        raise AssertionError(f"16,384 seeds launched {counts}")
    want, want_bad = _host_recombine_combine(seeds[:S], D, p)
    if one.dtype != np.int64 or bad != want_bad or not np.array_equal(one, want):
        raise AssertionError("16,384 seeds: the card's recombine != the host recombine")
    if one[dims].tolist() != _window_oracle(seeds[:S], D, p, bad, dims).tolist():
        raise AssertionError("16,384 seeds: the combine != the numpy oracle on its windows")

    real_fold, real_expand = ck.fold_masks_device, chacha.expand_masks

    def marked(seed_words, dimension, modulus, device=None):
        limbs, rej = real_fold(seed_words, dimension, modulus, device=device)
        rej = rej.copy()
        rej[0] += 1
        return limbs, rej

    def traded(seed_words, dimension, modulus):
        return np.stack([(np.asarray(r, dtype=np.int64) + 1) % modulus
                         for r in real_expand(seed_words, dimension, modulus)])

    with mock.patch.object(ck, "fold_masks_device", marked), \
            mock.patch.object(chacha, "expand_masks", traded):
        ck.fold_recombine_device_launches = 0
        _reset_counts()
        two, bad2 = ck.combine_masks_device(seeds, D, p, device=DEVICE)
        counts2 = {**_chacha_counts(), "fold_recombine_device": ck.fold_recombine_device_launches}
        unfixed, _ = ck.combine_masks_device(seeds, D, p, fixup_host=False, device=DEVICE)
        want2, want_bad2 = _host_recombine_combine(seeds, D, p)
        oracle2 = _window_oracle(seeds, D, p, bad2, dims)
    if counts2 != {"chacha_keystream": 0, "chacha_fold": 2, "fold_recombine_device": 2}:
        raise AssertionError(f"16,385 seeds launched {counts2}")
    if bad2 != [0, S] or want_bad2 != [0, S]:
        raise AssertionError(f"16,385 seeds: rejected {bad2}, not [0, {S}]")
    two = np.asarray(two, dtype=np.int64)
    if not np.array_equal(two, want2) or two[dims].tolist() != oracle2.tolist():
        raise AssertionError("16,385 seeds: the card's recombine and fold != the host's")
    if np.array_equal(two, np.asarray(unfixed, dtype=np.int64)):
        raise AssertionError("16,385 seeds: the fix-up traded no mask")

    def host_ms(fn):
        fn()
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)

    ctx = LimbContext.create(p)
    limbs, _ = ck.fold_masks_device(seeds[:S], D, p, device=DEVICE)

    def host_tail():
        la = limbs.cpu().numpy().astype(np.int64)
        return la[:, 0] | (la[:, 1] << 16) | (la[:, 2] << 32) | (la[:, 3] << 48)

    masked = np.random.default_rng(76).integers(0, p, size=D, dtype=np.int64)
    return {
        "counts": counts, "counts2": counts2, "bad2": bad2, "checked": len(dims),
        "combine_ms": host_ms(lambda: ck.combine_masks_device(seeds[:S], D, p, device=DEVICE)),
        "host_combine_ms": host_ms(lambda: _host_recombine_combine(seeds[:S], D, p)),
        "tail_ms": host_ms(lambda: ctx.recombine_i64(limbs).cpu().numpy()),
        "host_tail_ms": host_ms(host_tail),
        "sub_ms": host_ms(lambda: fields.trunc_sub_mod(masked, one, p)),
        "split_ms": host_ms(lambda: trunc_add_mod(masked, -one, p)),
        "shape": f"S={S} d={D} p=2^63-871",
    }


def _fused_recombine_lines(fr: dict, card: str) -> list[str]:
    med = {k: v[len(v) // 2] for k, v in fr.items() if k.endswith("_ms")}
    return [
        f"fused recombine: {fr['shape']}: {fr['counts']}, bit-equal to the host recombine; "
        f"16,385 seeds: {fr['counts2']}, seeds {fr['bad2']} marked rejected and their masks "
        f"traded, bit-equal to the host recombine, fold and fix-up; {fr['checked']} dimensions "
        f"a case exact against the numpy oracle",
        f"fused recombine: on {card}, host clock, median of {len(fr['combine_ms'])}: combine "
        f"{med['combine_ms']:.4f} ms (with the host recombine {med['host_combine_ms']:.4f}); "
        f"the tail alone {med['tail_ms']:.4f} ms (card recombine + the int64 copy) against "
        f"{med['host_tail_ms']:.4f} (the limbs' copy + host widen); unmask's trunc_sub_mod one pass "
        f"{med['sub_ms']:.4f} ms against the sign split {med['split_ms']:.4f}",
    ]


def phase_chunk_route(mhz: float, iters: int = 10):
    """256 seeds x 1,000,002 dimensions: S < 512, so the chunk route (B4 per
    seed chunk, the torch reduction, sum_mod), exact on both windows."""
    import numpy as np
    import torch

    from sda_tpu_torch import chacha
    from sda_tpu_torch.fields import find_special_prime_field
    from sda_tpu_torch.ops import chacha_kernel as ck
    from sda_tpu_torch.utils.profiling import cuda_time

    S, D = CHACHA["chunk_seeds"], CHACHA["dimension"]
    p = find_special_prime_field(63, 8, 9)[0]
    rng = np.random.default_rng(80)
    seeds = [chacha.new_seed(128, rng) for _ in range(S)]
    torch.cuda.synchronize()

    _reset_counts()
    t0 = time.perf_counter()
    out, bad = ck.combine_masks_device(seeds, D, p, device=DEVICE)
    host_s = time.perf_counter() - t0
    counts = _chacha_counts()
    if counts["chacha_fold"] or counts["chacha_keystream"] < 1:
        raise AssertionError(f"the chunk route launched {counts}")
    dims = _windows(D)
    if len(out) != D or [int(x) for x in out[dims]] != _window_oracle(
            seeds, D, p, bad, dims).tolist():
        raise AssertionError("the chunk route != the numpy oracle on its windows")

    seed_chunk = max(128, ck._CHUNK_BUDGET_BYTES // (D * 4 * 4))  # the budget rule, L = 4
    if counts["chacha_keystream"] != -(-S // seed_chunk):
        raise AssertionError(f"the chunk route launched B4 {counts['chacha_keystream']} times "
                             f"for {-(-S // seed_chunk)} seed chunks")
    nb = -(-2 * D // 16)
    chunk = min(S, seed_chunk)
    keys = ck._key_tensor(seeds[:chunk], torch.device(DEVICE))
    t = cuda_time(lambda i: ck._launch_keystream(keys, nb), iters=iters, warmup=2)
    ops = float(chunk) * nb * CHACHA_BLOCK_OPS
    nbytes = chunk * 32 + chunk * nb * 64
    bound_ms, bound_by, int32_only_ms = _chacha_bound(ops, nbytes, mhz)
    return {
        "launches": counts["chacha_keystream"], "timing": t, "host_ms": host_s * 1e3,
        "bad": len(bad), "bound_ms": bound_ms, "bound_by": bound_by,
        "int32_only_ms": int32_only_ms, "bytes": nbytes, "ops": ops,
        "shape": f"S={chunk} nblocks={nb} (one of {counts['chacha_keystream']} seed chunks of "
                 f"S={S} d={D})",
    }


def phase_fullmask():
    """64 canonical masks x 1,000,002 through FullMasker's forced device
    route (device_combine), against the host fold."""
    import numpy as np

    from sda_tpu_torch.fields import find_special_prime_field
    from sda_tpu_torch.masking import FullMasker
    from sda_tpu_torch.routing import RoutingPolicy

    n, D = CHACHA["fullmask"], CHACHA["dimension"]
    p = find_special_prime_field(63, 8, 9)[0]
    masks = list(np.random.default_rng(90).integers(0, p, size=(n, D), dtype=np.int64))
    t0 = time.perf_counter()
    got = FullMasker(p, routing=RoutingPolicy.force("device"), device=DEVICE).combine(masks)
    device_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = FullMasker(p, routing=RoutingPolicy.force("host")).combine(masks)
    host_s = time.perf_counter() - t0
    if not np.array_equal(got, want):
        raise AssertionError("the full-mask reveal on the card != the host fold")
    return {"device_ms": device_s * 1e3, "host_ms": host_s * 1e3,
            "shape": f"{n} masks x d={D} p=2^63-871"}


def _planar7_secrets(rows: int, nbp: int, mxu, seed: int):
    """A participation matrix synthesised on the card in B6's planar 7-bit
    layout; each element's top limb is masked so the element stays below
    2^(bits(p) - 1) <= p (canonical)."""
    import torch

    L7 = mxu.L7
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    d = torch.empty((rows, nbp), dtype=torch.uint8, device=DEVICE).random_(generator=gen)
    d &= 0x7F
    top_bits = mxu.ctx.p.bit_length() - 1 - 7 * (L7 - 1)
    d.view(rows // L7, L7, nbp)[:, L7 - 1] &= (1 << top_bits) - 1
    return d.view(torch.int8)


def _reveal7_check(engine, sec7, out, p_count: int, slots: int, width: int = 128,
                   times: int = 1, what: str = "gen-3 headline"):
    """B6's reveal on the first ``width`` batch positions against ``times`` x
    the modular sum of the secret slots decoded from ``sec7`` (``slots`` per
    participant: k in PRNG mode, k + r with the caller's randomness)."""
    import torch

    k, L7, L = engine.spec.secret_count, engine.mxu.L7, engine.ctx.L
    d = sec7[:, :width].cpu().to(torch.int64).reshape(p_count, slots, L7, width)[:, :k]
    value = sum(d[:, :, l] << (7 * l) for l in range(L7))  # < 2^63: exact in int64
    x16 = torch.stack([(value >> (16 * w)) & 0xFFFF for w in range(L)], dim=-1)
    once = engine.ctx.sum_mod(x16.permute(0, 2, 1, 3), axis=0)  # [width, k, L]
    ref = once
    for _ in range(times - 1):
        ref = engine.ctx.add_mod(ref, once)
    if not torch.equal(out[:width].cpu().to(torch.int64), ref):
        raise AssertionError(f"{what} reveal != modular participant sum")


def _int32_bound(ops: float, mhz: float, lanes: int = ISSUE_LANES) -> float:
    """ms for ``ops`` 32-bit integer instructions at 132 SMs x ``lanes``
    lanes a clock at the maximum SM clock."""
    return ops / (SMS * lanes * mhz * 1e6) * 1e3


def _mxu7_cost(plan, nbp: int):
    """(bytes, int8 operations, Philox calls) that one B6 launch needs: the
    operand, matrices and tables read once, the output written once; the
    contraction over the operand's rows and the randomness rows the data
    needs (8 * wpp per carry-save group, or RL per participant), into the
    n * L7 accumulator rows (and the stage-2 product); one Philox call per
    (lane, participant, word group)."""
    L7 = plan.mxu.L7
    out_bytes = (1 if plan.out7 else 4) * plan.n_out * (L7 if plan.out7 else plan.mxu.ctx.L) * nbp
    in_bytes = (plan.rows * nbp + plan.bigs.numel() + plan.bigr.numel() + plan.big2.numel()
                + 4 * plan.tables.numel())
    if plan.rand_mode == "sum":
        k_rand = plan.n_blocks * 8 * plan.words_per_p
    else:
        k_rand = plan.p_count * plan.RL
    ops = 2.0 * plan.n * L7 * (plan.rows + k_rand) * nbp
    if plan.n2:
        ops += 2.0 * plan.n2 * L7 * plan.n * L7 * nbp
    groups = -(-plan.words_per_p // 4)
    calls = float(nbp) * plan.p_count * groups if plan.rand_mode != "none" else 0.0
    return in_bytes + out_bytes, ops, calls


def _philox_call_ops(plan) -> int:
    """SASS instructions that B6 issues per Philox call in the plan's
    randomness mode, from the kernel instance the plan launches: the body of
    the innermost loop around the generator, one call per iteration. In
    rand-sum mode that loop holds no shared-memory store (the carry-save
    sums stay in registers); in grouped mode it stores the call's limbs."""
    from sda_tpu_torch.ops.mxu_kernel import KERNEL_VARIANTS
    from sda_tpu_torch.ops.sass import innermost_philox_loops, sass_listing

    if plan.rand_mode == "none":
        return 0
    instrs = sass_listing(*KERNEL_VARIANTS["mxu7_fused"])[f"MT{-(-plan.n * plan.mxu.L7 // 16)}"]
    stores = plan.rand_mode == "grouped"
    bodies = [b for b in innermost_philox_loops(instrs)
              if any(op.startswith("STS") for _, op, _ in b) == stores]
    if len(bodies) != 1:
        raise AssertionError(f"found {len(bodies)} {plan.rand_mode}-mode Philox loops in B6's SASS")
    return len(bodies[0])


def _mxu7_bound(plan, nbp: int, mhz: float):
    """B6's least time: the largest of its bytes over the HBM rate, its int8
    operations over the tensor-core rate, and its Philox calls' SASS
    instructions over the SMs' issue rate."""
    nbytes, ops, calls = _mxu7_cost(plan, nbp)
    parts = {"bytes": nbytes / PEAK_BYTES * 1e3, "int8": ops / PEAK_INT8 * 1e3,
             "philox": _int32_bound(calls * _philox_call_ops(plan), mhz)}
    bound = max(parts.values())
    return bound, "bytes" if parts["bytes"] == bound else "operations", parts


def _launch_report(plan, nbp: int, acc: bool = False, epilogue: bool = False) -> dict:
    """Shared memory per block and resident blocks per SM of the launch
    (the CUDA occupancy calculator), and ptxas's registers and spilled
    bytes of the instance it launches: a B6 launch for a gen-3 plan, else
    the B1/B2/B3 variant the plan and ``acc`` select (B2: its split kernel,
    or with ``epilogue`` its epilogue kernel)."""
    from sda_tpu_torch.ops import mxu8 as m8
    from sda_tpu_torch.ops import mxu_kernel as m7
    from sda_tpu_torch.ops.cuda_build import ptxas_report

    if isinstance(plan, m7.MxuPlan):
        (smem, blocks), mt, variant = m7.kernel_occupancy(plan, nbp), m7.kernel_mt(plan), "mxu7_fused"
        label = f"MT{mt}"
    else:
        smem, blocks = m8.kernel_occupancy(plan, nbp, acc, epilogue)
        mt, variant = m8.kernel_mt(plan), m8._variant(plan, acc)
        label = f"epi{mt}" if epilogue else f"MT{mt}"
    regs, spill = _ptxas_spills(ptxas_report(*_variants()[variant]))[label]
    return {"smem_bytes": smem, "blocks_per_sm": blocks, "instance": label,
            "registers": regs, "spill_bytes": spill}


def _launch_text(r: dict) -> str:
    return (f"{r['smem_bytes']} B shared memory per block, {r['blocks_per_sm']} blocks per SM, "
            f"{r['instance']} {r['registers']} registers / {r['spill_bytes']} B spilled")


def _compare_mxu7(eng, secrets, many, ext, lanes: int, seed0: int, label: str,
                  timed: bool = False):
    """B6 on the card against its plain version on CPU copies for one
    engine: caller randomness (``ext``) and rand-sum (``secrets``) at their
    participant count, grouped at ``many``'s, each combined only, ``out7``
    and with fused reconstruction (the reveal checked against the modular
    sum), plus the reconstruct-only call; ``timed``: the rand-sum launch
    with reconstruction timed beside its plain version. Returns (cases,
    max_abs_err, the times or None)."""
    import torch

    from sda_tpu_torch.ops import mxu_kernel as m7
    from sda_tpu_torch.utils.profiling import cuda_time

    spec, ctx = eng.spec, eng.ctx
    k, r, n = spec.secret_count, spec.randomness_count, spec.share_count
    P = secrets.shape[0]
    cases, max_err, mid = 0, 0, None

    def check(plans, sec7, seed, what):
        nonlocal cases, max_err
        got = m7.run_mxu(plans[0], sec7, seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = m7.run_mxu(plans[1], sec7.cpu(), seed)
        plain_s = time.perf_counter() - t0
        err = _max_err(got, want)
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"mxu7 kernel != plain at {what}: max err {err}")
        cases += 1
        return got, plain_s

    runs = [("ext", eng.planar7_ext(ext, lanes), P, secrets),
            ("sum", eng.planar7_secrets(secrets, lanes), P, secrets),
            ("grouped", eng.planar7_secrets(many, lanes), many.shape[0], many)]
    for mode, sec7, p_count, plain_secrets in runs:
        what = f"{label} ({mode}, NBP={sec7.shape[1]}, K={sec7.shape[0]})"
        for out7, rec in ((False, None), (True, None), (False, spec.reconstruct_matrix)):
            plans = [m7.mxu_plan(eng.mxu, spec.share_matrix, sec7.shape[0], p_count, k, r,
                                 out7=out7, reconstruct_matrix=rec, device=device)
                     for device in (DEVICE, "cpu")]
            if mode != "ext" and plans[0].rand_mode != mode:
                raise AssertionError(f"{what} took {plans[0].rand_mode} mode")
            got, plain_s = check(plans, sec7, seed0 + cases, f"{what} out7={out7} "
                                 f"rec={rec is not None}")
            if rec is not None:
                out = m7.batched_from_planar16(got, eng.nb)
                if not torch.equal(out.to(torch.int64), ctx.sum_mod(plain_secrets, axis=0)):
                    raise AssertionError(f"mxu7 reveal != modular sum at {what}")
                if timed and mode == "sum":
                    t = cuda_time(lambda i: m7.run_mxu(plans[0], sec7, i), iters=10, warmup=2)
                    mid = {"kernel_ms": t.median_ms, "plain_cpu_ms": plain_s * 1e3,
                           "shape": f"P={P} dim={eng.dimension} NBP={sec7.shape[1]}"}
    # the reconstruct-only call: one participant, the n clerks as slots
    comb = eng.mxu_kernel_combined(eng.planar7_ext(ext, lanes), 0, P, lanes)
    c7 = eng.mxu.limbs7_from_16(comb.permute(0, 2, 1)).permute(0, 2, 1)
    c7 = c7.reshape(-1, comb.shape[-1]).contiguous()
    plans = [m7.mxu_plan(eng.mxu, spec.reconstruct_matrix, c7.shape[0], 1, n, 0, device=d)
             for d in (DEVICE, "cpu")]
    check(plans, c7, 0, f"{label} (reconstruct-only, NBP={c7.shape[1]})")
    return cases, max_err, mid


def phase_compare_mxu7(P: int = 16, P_grouped: int = 131, dimension: int = 3000):
    """B6 on the card against its plain version on CPU copies at the mid
    shape and the four moduli (``_compare_mxu7``); share_mxu and the
    aggregate_mxu reveal on the card. Returns (cases, max_abs_err,
    mid-shape times)."""
    import numpy as np
    import torch

    cases, max_err, mid = 0, 0, {}
    for name, eng in _engines(dimension).items():
        ctx = eng.ctx
        rng = np.random.default_rng(13)
        secrets = eng.encode_secrets(rng.integers(0, min(ctx.p, 1 << 62), size=(P, dimension)))
        ext = torch.cat([secrets, eng.random_ext(P, rng=rng)], dim=2)
        many = eng.encode_secrets(rng.integers(0, min(ctx.p, 1 << 62), size=(P_grouped, dimension)))
        got = _compare_mxu7(eng, secrets, many, ext, LANES, 4321 + cases, name,
                            timed=name == "p63special")
        cases, max_err, mid = cases + got[0], max(max_err, got[1]), got[2] or mid
        # the plain-product route on the card (torch._int_mm)
        if not torch.equal(eng.share_mxu(ext), eng.share(ext)):
            raise AssertionError(f"share_mxu != CIOS share at {name}")
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(5)
        if not torch.equal(eng.aggregate_mxu(secrets, gen), ctx.sum_mod(secrets, axis=0)):
            raise AssertionError(f"aggregate_mxu reveal != modular sum at {name}")
    return cases, max_err, mid


# B6's ring cases, at 16 x 3 x L7 rows per 16 participants in rand-sum mode
# (x 7/3 with caller randomness): (what, modulus, participants, dimension,
# lanes). NBP = ceil(dimension / 3) rounded up to lanes, so lanes 16 leaves
# a block's last lanes past NBP, lanes 4 and 1 take the 4-byte and the byte
# copies of sec. Grouped mode needs more than 129 participants that do not
# split into equal carry-save groups, so each case runs it at P_GROUPED.
RING7_CASES = (
    ("K below one tile, P=1", "p63special", 1, 300, 16),
    ("K below one tile, P=2", "p63special", 2, 300, 16),
    ("K between one tile and the ring, not a multiple of 64", "p63special", 5, 300, 16),
    ("K of several tiles", "p63special", 16, 300, 128),
    ("NBP=100: 4-byte sec copies", "p63special", 5, 300, 4),
    ("NBP=101: byte sec copies", "p63special", 5, 303, 1),
    ("NBP=304: lanes past NBP in the third block", "p62", 5, 900, 16),
    ("128-bit field (MT10)", "p127special", 3, 300, 16),
    ("p433 (MT1)", "p433", 4, 300, 16),
)
P_GROUPED = 131


def phase_compare_ring7():
    """B6 against its plain version (``_compare_mxu7``) at every ring case,
    grouped mode at P_GROUPED. Returns (cases, max_abs_err)."""
    import numpy as np
    import torch

    cases, max_err, engines = 0, 0, {}
    for what, name, P, dim, lanes in RING7_CASES:
        if (name, dim) not in engines:
            engines[name, dim] = _engines(dim, {name})[name]
        eng = engines[name, dim]
        rng = np.random.default_rng(15)
        many = eng.encode_secrets(rng.integers(0, min(eng.ctx.p, 1 << 62), size=(P_GROUPED, dim)))
        ext = torch.cat([many[:P], eng.random_ext(P, rng=rng)], dim=2)
        got = _compare_mxu7(eng, many[:P], many, ext, lanes, 6000 + cases, f"ring case {what}")
        cases, max_err = cases + got[0], max(max_err, got[1])
    return cases, max_err


def phase_gen3_headline(mhz: float, iters: int = 20):
    """768 x 1,000,002 through aggregate_mxu_kernel: one B6 launch per
    step, PRNG mode; then the caller-randomness layout at the same width."""
    import torch

    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.ops import mxu_kernel as m7
    from sda_tpu_torch.utils.profiling import cuda_time

    engine = FederatedAggregation.packed_64bit(dimension=HEADLINE_DIM).engine
    spec, mxu = engine.spec, engine.mxu
    k, m, L = spec.secret_count, spec.secret_count + spec.randomness_count, engine.ctx.L
    nbp = -(-engine.nb // LANES) * LANES
    rows = HEADLINE_P * k * mxu.L7
    sec7 = _planar7_secrets(rows, nbp, mxu, seed=21)
    torch.cuda.synchronize()

    # the main path: one aggregation step, counted
    _reset_counts()
    out = engine.aggregate_mxu_kernel(sec7, 0, p_count=HEADLINE_P, lanes=LANES)
    torch.cuda.synchronize()
    counts = _counts()
    if counts != _only(mxu7_fused=1):
        raise AssertionError(f"the gen-3 headline step launched {counts}, not one B6 launch")
    if tuple(out.shape) != (engine.nb, k, L) or int(out.max()) > 0xFFFF or int(out.min()) < 0:
        raise AssertionError(f"gen-3 output has shape {tuple(out.shape)} or limbs out of range")
    _reveal7_check(engine, sec7, out, HEADLINE_P, k)

    # the plain version at the same shape, on the card, against the kernel
    plan = engine._plan7("share", rows, HEADLINE_P, sec7.device)
    if plan.rand_mode != "sum":
        raise AssertionError(f"the gen-3 headline took {plan.rand_mode} randomness mode")
    raw = m7.run_mxu(plan, sec7, 0)
    t_plain = cuda_time(lambda i: m7._fused_share_combine_mxu_plain(plan, sec7, 0), iters=1,
                        warmup=0)
    plain = m7._fused_share_combine_mxu_plain(plan, sec7, 0)
    err = int((raw.to(torch.int64) - plain.to(torch.int64)).abs().max())
    del plain
    if err:
        raise AssertionError(f"gen-3 headline kernel != plain version: max err {err}")

    t = cuda_time(lambda i: engine.aggregate_mxu_kernel(sec7, i, p_count=HEADLINE_P, lanes=LANES),
                  iters=iters, warmup=3)
    t0 = time.perf_counter()
    for i in range(iters):
        engine.aggregate_mxu_kernel(sec7, i, p_count=HEADLINE_P, lanes=LANES)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    bound_ms, bound_by, parts = _mxu7_bound(plan, nbp, mhz)
    # the launch's phases apart, through the same wrapper: the K loop alone
    # (no randomness), the randomness passes behind a one-tile K loop, and
    # neither (one tile and the epilogue)
    split = {
        "loop": (dataclasses.replace(plan, rand_mode="none", n_blocks=0), sec7),
        "randomness": (dataclasses.replace(plan, rows=64), sec7[:64]),
        "neither": (dataclasses.replace(plan, rows=64, rand_mode="none", n_blocks=0), sec7[:64]),
    }
    split_ms = {name: cuda_time(lambda i, q=q, x=x: m7.run_mxu(q, x, i), iters=10,
                                warmup=2).median_ms
                for name, (q, x) in split.items()}
    del sec7, raw
    torch.cuda.empty_cache()

    # the caller-randomness layout: k + r slots, the PRNG unused
    ext_rows = HEADLINE_P * m * mxu.L7
    ext7 = _planar7_secrets(ext_rows, nbp, mxu, seed=22)
    _reset_counts()
    out = engine.aggregate_mxu_kernel(ext7, 0, p_count=HEADLINE_P, lanes=LANES)
    torch.cuda.synchronize()
    if _counts() != _only(mxu7_fused=1):
        raise AssertionError(f"the caller-randomness step launched {_counts()}, not one B6 launch")
    _reveal7_check(engine, ext7, out, HEADLINE_P, m, what="gen-3 caller-randomness")
    t_ext = cuda_time(lambda i: engine.aggregate_mxu_kernel(ext7, 0, HEADLINE_P, LANES),
                      iters=5, warmup=1)
    ext_plan = engine._plan7("share", ext_rows, HEADLINE_P, ext7.device)
    ext_bound_ms, ext_bound_by, _ = _mxu7_bound(ext_plan, nbp, mhz)
    ext_launch = _launch_report(ext_plan, nbp)
    del ext7
    torch.cuda.empty_cache()
    return {
        "launches": counts["mxu7_fused"], "timing": t, "plain_ms": t_plain.median_ms,
        "max_abs_err": err, "step_ms": step_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "parts": parts, "philox_call_ops": _philox_call_ops(plan), "ext_timing": t_ext,
        "ext_bound_ms": ext_bound_ms,
        "ext_bound_by": ext_bound_by, "launch": _launch_report(plan, nbp),
        "ext_launch": ext_launch, "split_ms": split_ms,
        "shape": f"P={HEADLINE_P} dim={HEADLINE_DIM} rows={rows} NBP={nbp}",
        "ext_shape": f"P={HEADLINE_P} rows={ext_rows} NBP={nbp}",
    }


def phase_gen3_streaming(mhz: float, iters: int = 5):
    """14 chunks x 768 through aggregate_mxu_kernel_streaming: B6 per chunk,
    the torch add_mod, B6 for the reconstruction."""
    import torch

    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.utils.profiling import cuda_time

    c = CONFIG4
    engine = FederatedAggregation.packed_64bit(dimension=HEADLINE_DIM).engine
    k, mxu = engine.spec.secret_count, engine.mxu
    p_chunk, n_chunks = c["p_chunk"], c["n_chunks"]
    nbp = -(-engine.nb // LANES) * LANES
    rows = p_chunk * k * mxu.L7
    chunk = _planar7_secrets(rows, nbp, mxu, seed=41)  # resident, re-read per chunk
    torch.cuda.synchronize()

    def step(seed0):
        return engine.aggregate_mxu_kernel_streaming([lambda i: chunk] * n_chunks, p_chunk,
                                                     seed0=seed0, lanes=LANES)

    _reset_counts()
    out = step(1)
    torch.cuda.synchronize()
    counts = _counts()
    if counts != _only(mxu7_fused=n_chunks + 1):
        raise AssertionError(f"the gen-3 streaming step launched {counts}, not B6 x 15")
    if tuple(out.shape) != (engine.nb, k, engine.ctx.L):
        raise AssertionError(f"gen-3 streaming output has shape {tuple(out.shape)}")
    _reveal7_check(engine, chunk, out, p_chunk, k, times=n_chunks, what="gen-3 streaming")
    t_step = cuda_time(lambda i: step(100 + 7919 * n_chunks * i), iters=iters, warmup=1)
    t0 = time.perf_counter()
    for i in range(iters):
        step(5000 + 7919 * n_chunks * i)
    torch.cuda.synchronize()
    host_step_ms = (time.perf_counter() - t0) / iters * 1e3
    plan = engine._plan7("combine", rows, p_chunk, chunk.device)
    rec_plan = engine._plan7("reconstruct", engine.spec.share_count * mxu.L7, 1, chunk.device)
    t_chunk = cuda_time(lambda i: engine.mxu_kernel_combined(chunk, 30 + i, p_chunk, LANES),
                        iters=5, warmup=1)
    b_chunk = _mxu7_bound(plan, nbp, mhz)[0]
    b_rec = _mxu7_bound(rec_plan, nbp, mhz)[0]
    step_bound_ms = n_chunks * b_chunk + b_rec
    del chunk
    torch.cuda.empty_cache()
    return {
        "launches": counts["mxu7_fused"], "step": t_step, "host_step_ms": host_step_ms,
        "chunk_timing": t_chunk, "step_bound_ms": step_bound_ms,
        "launch": _launch_report(plan, nbp), "rec_launch": _launch_report(rec_plan, nbp),
        "idle_share": max(0.0, 1 - t_step.median_ms / host_step_ms),
        "shape": f"P={n_chunks}x{p_chunk} dim={HEADLINE_DIM} rows={rows}/chunk NBP={nbp}",
    }


def _planar_engines(dimension: int):
    """Engines of the planar compare: p433, the additive scheme mod
    2^61 - 1, a generic 62-bit prime and 2^127 - 1495."""
    from sda_tpu_torch.engine import TorchAggregationEngine
    from sda_tpu_torch.sharing import AdditiveScheme

    eng = _engines(dimension)
    add61 = TorchAggregationEngine(
        AdditiveScheme(share_count=4, modulus=(1 << 61) - 1).device_spec(), dimension,
        device=DEVICE,
    )
    return {"p433": eng["p433"], "additive61": add61, "p62": eng["p62"],
            "p127special": eng["p127special"]}


def phase_compare_planar(P: int = 16, dimension: int = 3000, rows: int = 8):
    """B7 on the card against its plain version on CPU copies at the mid
    shape, both randomness modes. Returns (cases, max_abs_err, times)."""
    import numpy as np
    import torch

    from sda_tpu_torch.ops import pallas_kernels as pk
    from sda_tpu_torch.utils.profiling import cuda_time

    cases, max_err, mid = 0, 0, {}
    for name, eng in _planar_engines(dimension).items():
        ctx, r = eng.ctx, eng.spec.randomness_count
        rng = np.random.default_rng(17)
        secrets = eng.encode_secrets(rng.integers(0, min(ctx.p, 1 << 62), size=(P, dimension)))
        ext = torch.cat([secrets, eng.random_ext(P, rng=rng)], dim=2)
        for mode, x in (("prng", secrets), ("ext", ext)):
            planar = pk.planar_from_batched(x, rows)
            seed = 77 + cases
            got = pk.fused_share_combine_planar(ctx, planar, eng.share_mat, r, seed=seed, rows=rows)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = pk.fused_share_combine_planar(ctx, planar.cpu(), eng.share_mat.cpu(), r,
                                                 seed=seed, rows=rows)
            plain_s = time.perf_counter() - t0
            err = int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"planar kernel != plain at {name} {mode}: max err {err}")
            out = eng.reconstruct(pk.batched_from_planar(got, eng.nb))
            if not torch.equal(out, ctx.sum_mod(secrets, axis=0)):
                raise AssertionError(f"planar reveal != modular sum at {name} {mode}")
            if name == "p62" and mode == "prng":
                t = cuda_time(lambda i: pk.fused_share_combine_planar(
                    ctx, planar, eng.share_mat, r, seed=i, rows=rows), iters=10, warmup=2)
                mid = {"kernel_ms": t.median_ms, "plain_cpu_ms": plain_s * 1e3,
                       "shape": f"P={P} dim={dimension} NBP={planar.shape[-2] * 128}"}
            cases += 1
    return cases, max_err, mid


def _planar_participant_ops(L: int, slots: int, m: int) -> dict:
    """SASS instructions that B7's L-limb instance issues per (lane,
    participant) with every clerk active (n = 8), split as ``_pipe_counts``
    splits them. Read from the listing: the participant loop holds the slot
    loop, whose body branches into the arm that loads a slot (the one with
    the global loads) or the arm that draws it (the one with the Philox
    multiplies), then runs the clerks' CIOS products. A participant runs
    the slot loop's common part m times, the load arm ``slots`` times, the
    draw arm m - slots times, and the participant loop's own instructions
    once."""
    from sda_tpu_torch.ops.pallas_kernels import KERNEL_VARIANTS
    from sda_tpu_torch.ops.sass import PHILOX_MUL_RE, branch_target, loops, sass_listing, span

    instrs = sass_listing(*KERNEL_VARIANTS["planar_cios"])[f"L{L}"]
    found = loops(instrs)
    slot = [(h, t) for h, t in found
            if any(op.startswith("LDG") for _, op, _ in span(instrs, h, t))
            and any(PHILOX_MUL_RE.search(a) for _, _, a in span(instrs, h, t))]
    slot = min(slot, key=lambda ht: ht[1] - ht[0])
    part = min(((h, t) for h, t in found if h < slot[0] and slot[1] < t),
               key=lambda ht: ht[1] - ht[0])
    body = span(instrs, *slot)
    # the slot test: the body's first forward branch; its fall-through arm
    # ends in an unconditional branch to the join
    test = next(i for i, (a, op, args) in enumerate(body)
                if op == "BRA" and branch_target(args) > a)
    target = branch_target(body[test][2])
    first = [x for x in body[test + 1:] if x[0] < target]
    if first[-1][1] != "BRA":
        raise AssertionError("B7's slot branch is not an if/else in the SASS")
    join = branch_target(first[-1][2])
    second = [x for x in body if target <= x[0] < join]
    load, draw = ((first, second) if any(op.startswith("LDG") for _, op, _ in first)
                  else (second, first))
    if not any(PHILOX_MUL_RE.search(a) for _, _, a in draw):
        raise AssertionError("B7's draw arm holds no Philox multiply in the SASS")
    common = [x for x in body if x not in first and x not in second]
    outer = [x for x in span(instrs, *part) if x not in body]
    pc = {name: _pipe_counts(seq) for name, seq in
          (("common", common), ("load", load), ("draw", draw), ("outer", outer))}
    return {key: m * pc["common"][key] + slots * pc["load"][key]
            + (m - slots) * pc["draw"][key] + pc["outer"][key] for key in pc["common"]}


def phase_gen1_headline(mhz: float, iters: int = 5, rows: int = 8):
    """768 x 1,000,002 through aggregate_fused: one B7 launch and the CIOS
    reconstruction per step; streaming over 3 chunks against one shot."""
    import torch

    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.ops import pallas_kernels as pk
    from sda_tpu_torch.utils.profiling import cuda_time

    engine = FederatedAggregation.packed_64bit(dimension=HEADLINE_DIM).engine
    ctx, spec = engine.ctx, engine.spec
    k, r, n, L = spec.secret_count, spec.randomness_count, spec.share_count, ctx.L
    m = k + r

    def limbs(p_count: int, slots: int, seed: int):
        """``[P, nb, slots, L]`` int32 canonical limbs on the card (the top
        limb masked below 2^(bits(p) - 1 - 48))."""
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(seed)
        x = torch.empty((p_count, engine.nb, slots, L), dtype=torch.int32, device=DEVICE)
        x.random_(0, 1 << 16, generator=gen)
        x[..., L - 1] &= (1 << (ctx.p.bit_length() - 1 - 16 * (L - 1))) - 1
        return x

    secrets = limbs(HEADLINE_P, k, 61)
    torch.cuda.synchronize()
    _reset_counts()
    out = engine.aggregate_fused(secrets, 0, rows=rows)
    torch.cuda.synchronize()
    counts = _counts()
    if counts != _only(planar_cios=1):
        raise AssertionError(f"the gen-1 headline step launched {counts}, not one B7 launch")
    if tuple(out.shape) != (engine.nb, k, L):
        raise AssertionError(f"gen-1 output has shape {tuple(out.shape)}")
    want = ctx.sum_mod(secrets[:, :128].to(torch.int64), axis=0)
    if not torch.equal(out[:128].to(torch.int64), want):
        raise AssertionError("gen-1 headline reveal != modular participant sum")
    t_step = cuda_time(lambda i: engine.aggregate_fused(secrets, i, rows=rows), iters=3, warmup=0)

    planar = pk.planar_from_batched(secrets, rows)
    del secrets, out
    nbp = planar.shape[-2] * 128
    got = pk.fused_share_combine_planar(ctx, planar, engine.share_mat, r, seed=3, rows=rows)
    table = pk._scalar_table(ctx, engine.share_mat, planar.device)
    slice_lanes = 1024
    sec = planar.view(HEADLINE_P, k, L, nbp)[..., :slice_lanes]
    t_plain = cuda_time(lambda i: pk._fused_share_combine_planar_plain(
        ctx, sec, table, k, m, n, True, 3), iters=1, warmup=0)
    plain = pk._fused_share_combine_planar_plain(ctx, sec, table, k, m, n, True, 3)
    err = int((got.view(n, L, nbp)[..., :slice_lanes].to(torch.int64)
               - plain.to(torch.int64)).abs().max())
    if err:
        raise AssertionError(f"gen-1 headline kernel != plain version: max err {err}")
    t = cuda_time(lambda i: pk.fused_share_combine_planar(ctx, planar, engine.share_mat, r,
                                                          seed=i, rows=rows),
                  iters=iters, warmup=1)
    del planar, got
    torch.cuda.empty_cache()

    # streaming: chunks of the caller's randomness layout against one shot
    pc, nc = GEN1_STREAM["p_chunk"], GEN1_STREAM["chunks"]
    ext = limbs(nc * pc, m, 62)
    one_shot = engine.aggregate_fused_ext(ext, rows=rows)
    _reset_counts()
    streamed = engine.aggregate_fused_streaming([ext[i * pc : (i + 1) * pc] for i in range(nc)],
                                                rows=rows)
    torch.cuda.synchronize()
    stream_counts = _counts()
    if stream_counts != _only(planar_cios=nc):
        raise AssertionError(f"gen-1 streaming launched {stream_counts}, not B7 x {nc}")
    if not torch.equal(one_shot, streamed):
        raise AssertionError("gen-1 streaming != the one-shot result")
    if not torch.equal(streamed[:128].to(torch.int64),
                       ctx.sum_mod(ext[:, :128, :k].to(torch.int64), axis=0)):
        raise AssertionError("gen-1 streaming reveal != modular participant sum")
    del ext, one_shot, streamed
    torch.cuda.empty_cache()

    if n != 8:
        raise AssertionError(f"the gen-1 bound counts 8 active clerks, the model has {n}")
    ops = _planar_participant_ops(L, k, m)
    work = float(HEADLINE_P) * nbp
    nbytes = 4.0 * (HEADLINE_P * k * L * nbp + n * L * nbp + (m + 2) * n * L + L)
    parts = {"bytes": nbytes / PEAK_BYTES * 1e3, "issue": _int32_bound(ops["total"] * work, mhz)}
    bound_ms = max(parts.values())
    # where this code's instructions execute: not a bound of the function
    pipes = {"fma": _int32_bound(ops["fma"] * work, mhz, INT32_LANES),
             "alu": _int32_bound(ops["alu"] * work, mhz, INT32_LANES)}
    return {
        "launches": counts["planar_cios"], "timing": t, "step": t_step,
        "plain_ms": t_plain.median_ms, "plain_shape": f"P={HEADLINE_P} first {slice_lanes} lanes",
        "max_abs_err": err, "bound_ms": bound_ms,
        "bound_by": "bytes" if parts["bytes"] == bound_ms else "operations", "parts": parts,
        "pipes": pipes, "ops": ops, "work": work,
        "stream_launches": stream_counts["planar_cios"],
        "shape": f"P={HEADLINE_P} dim={HEADLINE_DIM} rows={rows} NBP={nbp}",
    }


def _probe_cases():
    """The probes at the shapes their tools give them: (name, input,
    out_rows (T1, T2, T3) or output words (T1'), n_chunks, splits (T3:
    B2's at config 3), shape label)."""
    import torch

    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.ops.mxu8 import launch_splits
    from sda_tpu_torch.tools._common import make_planar_secrets

    e2 = FederatedAggregation.packed_64bit(dimension=SERVING["dimension"]).engine
    e3 = FederatedAggregation.packed_128bit(dimension=CONFIG3["dimension"]).engine
    job_lanes = -(-e2.nb // 128) * 128
    rows2 = SERVING["participants"] * e2.spec.secret_count * e2.mxu8.L8
    c = CONFIG3
    rows3 = c["p_chunk"] * e3.spec.secret_count * e3.mxu8.L8
    nbp3 = -(-e3.nb // c["lanes"]) * c["lanes"]
    splits3 = launch_splits(e3._plan("share", rows3, c["p_chunk"], DEVICE, c["n_chunks"]), nbp3,
                            DEVICE)
    return [
        ("T1", make_planar_secrets(e2, 101, rows2, job_lanes), e2.ctx.L * e2.spec.secret_count, 1,
         None, f"config-2 job: rows={rows2} NBP={job_lanes}"),
        ("T1'", torch.zeros((8, 128), dtype=torch.int8, device=DEVICE), 8 * 128, 1, None,
         "bare: 1 KB in, 4 KB out"),
        ("T2", make_planar_secrets(e2, 102, rows2, SERVING["jobs"] * job_lanes),
         e2.ctx.L * e2.spec.secret_count, 1, None,
         f"serving: rows={rows2} NBP={SERVING['jobs'] * job_lanes}"),
        ("T3", torch.cat([make_planar_secrets(e3, 103 + i, rows3, nbp3)
                          for i in range(c["n_chunks"])]),
         e3.ctx.L * e3.spec.secret_count, c["n_chunks"], splits3,
         f"config 3: {c['n_chunks']} chunks x rows={rows3} NBP={nbp3}, B2's split grid: S="
         f"{splits3} x {nbp3 // 128} lane blocks = {splits3 * nbp3 // 128} blocks"),
    ]


def phase_probe_compare():
    """T1, T1', T2 and T3 on the card against their plain versions on CPU
    copies of the same inputs: the output seed-filled and bit-equal, every
    sink bit-equal, and the XOR of the sinks equal to torch's XOR of the
    input's words on the card. Then each probe, its plain version on the
    card and the library call at that shape, timed with CUDA events."""
    import torch

    from sda_tpu_torch.ops import probes
    from sda_tpu_torch.utils.profiling import cuda_time_samples

    def run(name, x, out_size, n_chunks, splits, seed):
        if name == "T1'":
            return probes.probe_t1_bare(x, out_size, seed)
        if name == "T3":
            return probes.probe_t3(x, out_size, n_chunks, seed, splits)
        return (probes.probe_t1 if name == "T1" else probes.probe_t2)(x, out_size, seed)

    res = {}
    for name, x, out_size, n_chunks, splits, shape in _probe_cases():
        seed = 0x9E3779B9  # bit 31 set: the int32 view of the fill is negative
        out, sink = run(name, x, out_size, n_chunks, splits, seed)
        torch.cuda.synchronize()
        want_out, want_sink = run(name, x.cpu(), out_size, n_chunks, splits, seed)
        err = max(int((out.cpu().to(torch.int64) - want_out.to(torch.int64)).abs().max()),
                  int((sink.cpu().to(torch.int64) - want_sink.to(torch.int64)).abs().max()))
        if err or int(out[0].flatten()[0]) & 0xFFFFFFFF != seed:
            raise AssertionError(f"probe {name} != its plain version: max err {err}")
        if probes.xor_words(sink) != probes.xor_words(x):
            raise AssertionError(f"probe {name}: the sinks' XOR != torch's XOR of the input")
        t = cuda_time_samples(lambda i: run(name, x, out_size, n_chunks, splits, i), samples=5,
                              iters=10)
        if name == "T1'":
            sink_plain = probes.xor_words
        else:
            sink_plain = functools.partial(probes._sink_plain, n_chunks=n_chunks, splits=splits)
        t_plain = cuda_time_samples(lambda i: (out.fill_(i), sink_plain(x)), samples=3, iters=2)
        t_lib = cuda_time_samples(lambda i: probes.library_probe(x, out, i), samples=5, iters=10)
        nbytes = probes.probe_bytes(x, out, sink)
        res[name] = {"max_abs_err": err, "timing": t, "plain_ms": t_plain.median_ms,
                     "library_ms": t_lib.median_ms, "bound_ms": nbytes / PEAK_BYTES * 1e3,
                     "bytes": nbytes, "shape": shape, "splits": splits}
        del x, out, sink
    torch.cuda.empty_cache()
    return res


def _tool_launches(name: str, tool, artifact) -> dict:
    """The launches a tool's run must count: every check call, plus
    ``timed_calls`` per timed experiment."""
    from sda_tpu_torch.tools._common import timed_calls

    n = timed_calls(tool.SAMPLES, tool.ITERS)
    if name == "latency":
        # B1: the job and the 64-job launch, each checked then timed; T1 and
        # T1': checked then timed
        return _only(mxu8_fused=2 + n + timed_calls(tool.SAMPLES, tool.BATCH_ITERS),
                     probe_t1=1 + n, probe_t1_bare=1 + n)
    if name == "lane_batch":
        # B1: the batch and the 4x batch checked; five timed experiments
        return _only(mxu8_fused=2 + 5 * n, probe_t2=1 + n)
    # config 3: each row checked then timed, B1 at one chunk and B2 above;
    # two controls at the best row; T3 at the best row and the best
    # multi-chunk row, each checked then timed
    fused = sum(1 + n for row in artifact["rows"] if row["n_chunks"] == 1)
    chunked = sum(1 + n for row in artifact["rows"] if row["n_chunks"] > 1)
    if artifact["best"]["n_chunks"] == 1:
        fused += 2 * n
    else:
        chunked += 2 * n
    return _only(mxu8_fused=fused, mxu8_chunked=chunked, probe_t3=2 * (1 + n))


def phase_tools():
    """The port's three probe tools at the reference's shapes, each with the
    launch counters set to 0 just before it and read just after, and held
    to exactly the launches its experiments make; each writes its artifact
    under build/measurements/."""
    import torch

    from sda_tpu_torch.tools import _common
    from sda_tpu_torch.tools import measure_config3_variants as c3
    from sda_tpu_torch.tools import measure_lane_batch_floor as lb
    from sda_tpu_torch.tools import measure_latency_floor as lf

    res = {}
    for name, tool, artifact_name in (("latency", lf, "LATENCY_FLOOR"),
                                      ("lane_batch", lb, "LANE_BATCH_FLOOR"),
                                      ("config3", c3, "CONFIG3_SWEEP")):
        _reset_counts()
        t0 = time.perf_counter()
        artifact = tool.measure()
        torch.cuda.synchronize()
        counts = _counts()
        want = _tool_launches(name, tool, artifact)
        if counts != want:
            raise AssertionError(f"the {name} tool launched {counts}, not {want}")
        res[name] = {"artifact": artifact, "counts": counts, "s": time.perf_counter() - t0,
                     "path": _common.write_artifact(artifact_name, artifact)}
        torch.cuda.empty_cache()
    return res


def _counted(fn, what: str, **launches):
    """One call of ``fn`` with the launch counts set to 0 just before it and
    read just after; they must equal ``launches`` exactly."""
    import torch

    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    if _counts() != _only(**launches):
        raise AssertionError(f"{what} launched {_counts()}, not {launches}")
    return out


def _bit_equal(got, want, what: str):
    import torch

    if tuple(got.shape) != tuple(want.shape) or not torch.equal(got.to(torch.int64),
                                                                want.to(torch.int64)):
        raise AssertionError(f"{what}: the mesh's output != the engine's single-device output")


def _slots_view(sec, p_count: int, slots: int, k: int, L: int, width: int = 128):
    """The secret slots of the first ``width`` lanes of a caller-randomness
    planar tensor (``slots`` per participant), as a ``k``-slot planar
    tensor: what the reveal checks read."""
    return sec[:, :width].reshape(p_count, slots, L, width)[:, :k].reshape(-1, width)


def phase_mesh(mesh, iters: int = 10):
    """The multi-device pipeline (``sda_tpu_torch.parallel``) in a world of
    one on ``mesh``, at full width: each step counted, its reveal checked,
    caller-randomness outputs bit-equal to the engine's single-device entry
    points, and the step timed beside them with CUDA events."""
    import numpy as np
    import torch

    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.ops.modmat import uniform_limbs
    from sda_tpu_torch.parallel import ShardedAggregationPipeline
    from sda_tpu_torch.tools._common import make_planar_secrets, reveal_check_slice
    from sda_tpu_torch.utils.profiling import cuda_time, device_breakdown

    model = FederatedAggregation.packed_64bit(dimension=HEADLINE_DIM)
    engine = model.engine
    pipe = ShardedAggregationPipeline(engine, mesh)
    spec, mxu, L8 = engine.spec, engine.mxu, engine.mxu8.L8
    k, nb, P = spec.secret_count, engine.nb, HEADLINE_P
    m = k + spec.randomness_count
    nbp = -(-nb // LANES) * LANES
    res = {"launches": {}}
    t0 = time.perf_counter()

    def counted(fn, what, **want):
        out = _counted(fn, what, **want)
        res["launches"][what] = {name: n for name, n in _counts().items() if n}
        return out

    def timed(name, mesh_fn, engine_fn, n=iters, warmup=2):
        res[name] = {"mesh": cuda_time(mesh_fn, iters=n, warmup=warmup),
                     "engine": cuda_time(engine_fn, iters=n, warmup=warmup)}

    # jnp: the CIOS step (share matmul, transposition, combine, reconstruction)
    n_jnp = MESH["jnp_participants"]
    secrets, gen = model.example_inputs(participants=n_jnp, seed=3)
    rand = uniform_limbs(engine.ctx, gen, (n_jnp, nb, spec.randomness_count))
    out = counted(lambda: pipe.aggregate(secrets, rand), "the mesh jnp step")
    _bit_equal(out, engine.aggregate(secrets, rand), "jnp")
    raw = np.random.default_rng(3).integers(0, min(spec.modulus, 1 << 31),
                                            size=(n_jnp, HEADLINE_DIM))
    if not np.array_equal(model.reveal(out).astype(np.int64), raw.sum(axis=0) % spec.modulus):
        raise AssertionError("mesh jnp reveal != numpy sum mod p")
    timed("jnp", lambda i: pipe.aggregate(secrets, rand),
          lambda i: engine.aggregate(secrets, rand), n=2, warmup=0)
    del secrets, rand, out
    torch.cuda.empty_cache()

    # gen 3: B6 per shard, then a B6 reconstruction
    sec7 = _planar7_secrets(P * k * mxu.L7, nbp, mxu, seed=61)
    out = counted(lambda: pipe.aggregate_mxu(sec7, 1), "the mesh gen-3 step", mxu7_fused=2)
    if tuple(out.shape) != (nbp, k, engine.ctx.L):
        raise AssertionError(f"mesh gen-3 output has shape {tuple(out.shape)}")
    _reveal7_check(engine, sec7, out, P, k, what="mesh gen-3")
    timed("gen3", lambda i: pipe.aggregate_mxu(sec7, i),
          lambda i: engine.aggregate_mxu_kernel(sec7, i, P, LANES))
    res["gen3_kernels_ms"] = device_breakdown(lambda i: pipe.aggregate_mxu(sec7, i))
    res["gen3_by_op_ms"] = _device_ms_by_op(lambda i: pipe.aggregate_mxu(sec7, i))
    n7 = MESH["stream7_chunks"]
    out = counted(lambda: pipe.aggregate_mxu_streaming([lambda i: sec7] * n7, seed0=3),
                   "the mesh gen-3 stream", mxu7_fused=n7 + 1)
    _reveal7_check(engine, sec7, out, P, k, times=n7, what="mesh gen-3 streaming")
    timed("gen3_stream",
          lambda i: pipe.aggregate_mxu_streaming([lambda c: sec7] * n7, seed0=100 + 7919 * n7 * i),
          lambda i: engine.aggregate_mxu_kernel_streaming([lambda c: sec7] * n7, P,
                                                          seed0=100 + 7919 * n7 * i, lanes=LANES),
          n=3, warmup=1)
    del sec7
    torch.cuda.empty_cache()
    ext7 = _planar7_secrets(P * m * mxu.L7, nbp, mxu, seed=62)
    out = counted(lambda: pipe.aggregate_mxu_ext(ext7), "the mesh gen-3 ext step", mxu7_fused=2)
    _bit_equal(out[:nb], engine.aggregate_mxu_kernel(ext7, 0, P, LANES), "gen-3 ext")
    _reveal7_check(engine, ext7, out, P, m, what="mesh gen-3 caller-randomness")
    timed("gen3_ext", lambda i: pipe.aggregate_mxu_ext(ext7),
          lambda i: engine.aggregate_mxu_kernel(ext7, 0, P, LANES), n=5, warmup=1)
    del ext7, out
    torch.cuda.empty_cache()

    # gen 4: B1 per shard (B3 for a stream's later chunks), a B1 reconstruction
    sec8 = make_planar_secrets(engine, 64, P * k * L8, nbp)
    out = counted(lambda: pipe.aggregate_mxu8(sec8, 1), "the mesh gen-4 step", mxu8_fused=2)
    if tuple(out.shape) != (nbp, k, engine.ctx.L):
        raise AssertionError(f"mesh gen-4 output has shape {tuple(out.shape)}")
    reveal_check_slice(engine, sec8, out, P, what="mesh gen-4")
    timed("gen4", lambda i: pipe.aggregate_mxu8(sec8, i),
          lambda i: engine.aggregate_mxu8_kernel(sec8, i, P, LANES), n=20, warmup=3)
    res["gen4_kernels_ms"] = device_breakdown(lambda i: pipe.aggregate_mxu8(sec8, i))
    res["gen4_by_op_ms"] = _device_ms_by_op(lambda i: pipe.aggregate_mxu8(sec8, i))
    n8 = CONFIG4["n_chunks"]
    out = counted(lambda: pipe.aggregate_mxu8_streaming([lambda i: sec8] * n8, seed0=1),
                   "the mesh gen-4 stream", mxu8_fused=2, mxu8_acc=n8 - 1)
    reveal_check_slice(engine, sec8, out, P, times=n8, what="mesh gen-4 streaming")
    timed("gen4_stream",
          lambda i: pipe.aggregate_mxu8_streaming([lambda c: sec8] * n8, seed0=100 + n8 * i),
          lambda i: engine.aggregate_mxu8_kernel_streaming([lambda c: sec8] * n8, P,
                                                           seed0=100 + n8 * i, lanes=LANES),
          n=3, warmup=1)

    # lane batch: two jobs side by side on the lane axis, one step
    job_b = make_planar_secrets(engine, 66, P * k * L8, nbp)
    batched = engine.concat_jobs_lanes([sec8, job_b])
    out = counted(lambda: pipe.aggregate_mxu8_streaming([batched], seed0=2),
                   "the mesh lane batch", mxu8_fused=2)
    for j, job in enumerate((sec8, job_b)):
        reveal_check_slice(engine, job, out[j * nbp:], P, what=f"mesh lane-batch job {j}")
    timed("lane_batch", lambda i: pipe.aggregate_mxu8_streaming([batched], seed0=i),
          lambda i: engine.aggregate_mxu8_kernel_jobs(batched, i, P, 2, lanes=LANES), n=5)
    del sec8, job_b, batched
    torch.cuda.empty_cache()

    # the caller's randomness: bit-equal to the engine, one chunk and two
    ext8 = make_planar_secrets(engine, 65, P * m * L8, nbp)
    full = counted(lambda: pipe.aggregate_mxu8_streaming([ext8], ext=True),
                    "the mesh gen-4 ext step", mxu8_fused=2)
    _bit_equal(full[:nb], engine.aggregate_mxu8_kernel(ext8, 0, P, LANES), "gen-4 ext")
    reveal_check_slice(engine, _slots_view(ext8, P, m, k, L8), full, P,
                       what="mesh gen-4 caller-randomness")
    out = counted(lambda: pipe.aggregate_mxu8_streaming([ext8, ext8], ext=True),
                   "the mesh gen-4 ext stream", mxu8_fused=2, mxu8_acc=1)
    _bit_equal(out[:nb], engine.aggregate_mxu8_kernel_streaming([ext8, ext8], P, lanes=LANES),
               "gen-4 ext stream")

    # the degraded committee: the chunk's partial sums once, then each subset
    part = counted(lambda: pipe.mxu8_partials([ext8], ext=True), "the mesh chunk loop",
                    mxu8_fused=1)
    res["degraded"] = []
    for drop in MESH["drops"]:
        subset = [i for i in range(spec.share_count) if i != drop]
        mat = model.scheme.reconstruct_matrix(subset)
        out = counted(lambda: pipe.aggregate_mxu8_degraded(part, subset, mat),
                       f"the degraded finish without clerk {drop}", mxu8_fused=1)
        _bit_equal(out, full, f"degraded finish without clerk {drop}")
        res["degraded"].append(cuda_time(lambda i: pipe.aggregate_mxu8_degraded(part, subset, mat),
                                         iters=iters, warmup=2))
    res["full_finish"] = cuda_time(lambda i: engine.reconstruct_planar8(part, LANES), iters=iters,
                                   warmup=2)
    del ext8, part, full, out
    torch.cuda.empty_cache()
    res["shape"] = f"P={P} dim={HEADLINE_DIM} NBP={nbp}"
    res["s"] = time.perf_counter() - t0
    return res


def phase_drivers():
    """The drivers on the card: ``graft_entry.entry()``'s forward step,
    ``graft_entry.dryrun_multichip(1)`` in a world of one, then the scaling
    bench's config-5 split at full width and its weak-scaling row ``n = 1``
    in a world of one, each counted exactly and its reveal checked, timed
    by the bench's own functions (CUDA events)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sda_tpu_torch import graft_entry
    from sda_tpu_torch.parallel import make_mesh
    from sda_tpu_torch.tools import bench_scaling as bs
    from sda_tpu_torch.tools._common import bound, mxu8_cost, reveal_check_slice

    res = {"launches": {}}
    t0 = time.perf_counter()

    def counted(fn, what, **want):
        out = _counted(fn, what, **want)
        res["launches"][what] = {name: n for name, n in _counts().items() if n}
        return out

    # entry(): the CIOS forward step on the card, no kernel
    fn, (secrets, gen) = graft_entry.entry()
    model = fn.__self__
    out = counted(lambda: fn(secrets, gen), "the entry forward step")
    raw = np.random.default_rng(0).integers(0, min(model.scheme_modulus, 1 << 31),
                                            size=(16, 1024))
    if not np.array_equal(model.reveal(out).astype(np.int64),
                          raw.sum(axis=0) % model.scheme_modulus):
        raise AssertionError("entry() reveal != numpy sum mod p")
    del secrets, gen, out
    # the dryrun's seven checks in a world of one on NCCL, made and closed by it
    counted(lambda: graft_entry.dryrun_multichip(1), "the dryrun", **DRYRUN_LAUNCHES)

    mesh = make_mesh(MESH_AXES)
    c = CONFIG5
    case = bs.config5_case(mesh, c["participants_per_device"], c["dim_per_device"], c["chunks"])
    engine, n = case.pipe.engine, c["chunks"]
    acc = counted(lambda: case.loop(0), "the config-5 chunk loop", mxu8_fused=1,
                  mxu8_acc=n - 1)
    out = counted(lambda: case.finish(acc), "the config-5 finish", mxu8_fused=1)
    reveal_check_slice(engine, case.planar, out, case.p_chunk, width=bs.LANES, times=n,
                       what="config-5 split")
    loop, finish = bs.time_config5(case, acc, "cuda")
    row = bs.config5_row(case, loop.median_ms / 1e3, finish.median_ms / 1e3)
    rows, nbp = case.planar.shape
    plan = engine._plan("combine", rows, case.p_chunk, case.planar.device)
    rec = engine._plan("reconstruct", engine.spec.share_count * engine.mxu8.L8, 1,
                       case.planar.device)
    loop_bound = bound([mxu8_cost(plan, nbp)] + [mxu8_cost(plan, nbp, acc=True)] * (n - 1))
    res["config5"] = {"row": row, "loop": loop, "finish": finish, "loop_bound": loop_bound,
                      "finish_bound": bound([mxu8_cost(rec, nbp)]),
                      "sec_gb": case.planar.numel() / 1e9, "nbp": nbp, "width": bs.LANES}
    del case, acc, out
    torch.cuda.empty_cache()

    weak = bs.weak_case(mesh, c["participants_per_device"], c["dim_per_device"])
    out = counted(lambda: weak.step(0), "the weak-scaling step", mxu8_fused=2)
    reveal_check_slice(weak.pipe.engine, weak.inputs, out, weak.p_count, what="weak-scaling row")
    step = bs.time_calls(weak.step, "cuda", bs.STEP_ITERS)
    res["weak"] = {"row": bs.weak_row(step.median_ms / 1e3, weak.fieldops, 1, None, "cuda"),
                   "step": step, "p_count": weak.p_count,
                   "dimension": weak.pipe.engine.dimension}
    del weak, out
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    res["s"] = time.perf_counter() - t0
    return res


def _drivers_lines(r: dict, card: str, b3_ms: float) -> list[str]:
    c5, wk = r["config5"], r["weak"]
    row, loop, fin = c5["row"], c5["loop"], c5["finish"]
    per_chunk = loop.median_ms / row["chunks"]
    w = wk["row"]
    return [
        f"drivers: on {card}, {r['s']:.1f} s in all: graft_entry.entry() forward (16 x 1024, "
        f"CIOS, no kernel) revealed exactly; graft_entry.dryrun_multichip(1) on NCCL, world 1: "
        f"OK, launches {r['launches']['the dryrun']} exact",
        f"drivers: config-5 split (bench_scaling, world 1) {row['chunks']} chunks x "
        f"{row['participants'] // row['chunks']} = {row['participants']} participants x "
        f"{row['dimension']} on {card}: chunk loop (B1 x 1 + B3 x {row['chunks'] - 1}) median "
        f"{loop.median_ms:.4f} ms (min {loop.min_ms:.4f}, max {loop.max_ms:.4f}), "
        f"{per_chunk:.4f} ms a chunk (config 4's B3 launch {b3_ms:.4f} ms), bound "
        f"{c5['loop_bound'][0]:.4f} ms ({c5['loop_bound'][1]}), "
        f"{c5['loop_bound'][0] / loop.median_ms:.2f} of it; finish (B1 x 1) median "
        f"{fin.median_ms:.4f} ms (min {fin.min_ms:.4f}, max {fin.max_ms:.4f}), bound "
        f"{c5['finish_bound'][0]:.4f} ms; comm_fraction {row['comm_fraction']:.6f}, "
        f"gfieldops_per_s {row['gfieldops_per_s']:.4f}, allreduce_payload_mb "
        f"{row['allreduce_payload_mb']:.6f}; sec buffer {c5['sec_gb']:.2f} GB (NBP "
        f"{c5['nbp']}); reveal exact on the first {c5['width']} lanes",
        f"drivers: weak-scaling row n=1 (bench_scaling, world 1) {wk['p_count']} x "
        f"{wk['dimension']} on {card}: aggregate_mxu8 (B1 x 2) median "
        f"{wk['step'].median_ms:.4f} ms (min {wk['step'].min_ms:.4f}, max "
        f"{wk['step'].max_ms:.4f}), gfieldops_per_s {w['gfieldops_per_s']:.4f}, "
        f"weak_scaling_efficiency {w['weak_scaling_efficiency']:.4f}; reveal exact",
    ]


def _plain_session_counts(fn, iters: int = 5) -> collections.Counter:
    """Device activities by kernel name in a plain ``torch.profiler``
    session of ``iters`` calls after one untraced call, with no throwaway
    session before it and no check: how the whole script's profiles were
    taken before ``profiling.profile_calls``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sda_tpu_torch.utils.profiling import kernel_name

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(3000 + i)
        torch.cuda.synchronize()
    return collections.Counter(kernel_name(e.name) for e in prof.events()
                               if e.device_type == DeviceType.CUDA
                               and not getattr(e, "is_user_annotation", False))


def phase_breakdown(iters: int = 5):
    """``device_breakdown`` of the headline step (B1 x 1) and of the mesh's
    gen-4 step (B1 x 2) at the end of the script: each kernel's count of
    activities against the launch counters (``iters`` traced calls after
    one untraced), the kernels' sums against the step's CUDA-event time
    (per call, as the headline phase times it, and the card's own time in
    windows queued behind a spin, which holds no host submission), and
    beside it the count of a plain session with no throwaway before it."""
    import torch
    import torch.distributed as dist

    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.parallel import ShardedAggregationPipeline, make_mesh
    from sda_tpu_torch.tools._common import make_planar_secrets
    from sda_tpu_torch.utils.profiling import (_ATTEMPTS, _breakdown_from_events, cuda_time,
                                               cuda_time_samples, device_activities,
                                               kernel_name, profile_calls)

    engine = FederatedAggregation.packed_64bit(dimension=HEADLINE_DIM).engine
    k, L8 = engine.spec.secret_count, engine.mxu8.L8
    nbp = -(-engine.nb // LANES) * LANES
    sec8 = make_planar_secrets(engine, 7, HEADLINE_P * k * L8, nbp)
    pipe = ShardedAggregationPipeline(engine, make_mesh(MESH_AXES))
    steps = {
        "headline step (B1 x 1)": (lambda i: engine.aggregate_mxu8_kernel(
            sec8, i, p_count=HEADLINE_P, lanes=LANES), 1),
        "mesh gen-4 step (B1 x 2)": (lambda i: pipe.aggregate_mxu8(sec8, i), 2),
    }
    res = {}
    for label, (fn, per_call) in steps.items():
        events_t = cuda_time(fn, iters=10, warmup=2)
        card_t = cuda_time_samples(fn, samples=5, iters=3)
        plain = _plain_session_counts(fn, iters)
        _reset_counts()
        events = device_activities(profile_calls(fn, iters)[0])
        launches = _counts()["mxu8_fused"]
        counts = collections.Counter(kernel_name(name) for name, *_ in events)
        sessions = (launches // per_call - 1) // iters  # profile_calls' attempts
        if (launches != per_call * (1 + sessions * iters) or not 1 <= sessions <= _ATTEMPTS
                or counts["mxu8_fused_kernel"] != per_call * iters):
            raise AssertionError(f"{label}: B1 launched {launches} times, traced "
                                 f"{counts['mxu8_fused_kernel']} times in {iters} calls")
        by_kernel = _breakdown_from_events(events, iters)
        total = sum(by_kernel.values())
        if total < 0.9 * card_t.min_ms:
            raise AssertionError(f"{label}: the kernels' sum {total:.4f} ms reads below 0.9 of "
                                 f"the card's time for the step ({card_t.min_ms:.4f} ms at least)")
        res[label] = {"events": events_t, "card": card_t, "launches": launches,
                      "sessions": sessions, "counts": counts,
                      "by_kernel_ms": by_kernel, "total_ms": total,
                      "plain_b1": plain["mxu8_fused_kernel"], "plain_total": sum(plain.values()),
                      "traced_total": sum(counts.values())}
    dist.destroy_process_group()
    del sec8, pipe
    torch.cuda.empty_cache()
    return res


def _breakdown_lines(r: dict, card: str, iters: int = 5) -> list[str]:
    lines = []
    for label, b in r.items():
        t, tc = b["events"], b["card"]
        b1 = b["by_kernel_ms"]["mxu8_fused_kernel"]
        top = ", ".join(f"{name} {ms:.4f}" for name, ms in list(b["by_kernel_ms"].items())[:6])
        lines.append(
            f"breakdown: {label} on {card}: device_breakdown over {iters} calls (after a "
            f"throwaway session; {b['sessions']} traced session(s) to a whole trace): B1 launch "
            f"counter {b['launches']} in {1 + b['sessions'] * iters} calls, traced "
            f"mxu8_fused_kernel {b['counts']['mxu8_fused_kernel']} in {iters} (every kernel's "
            f"count a multiple of {iters}: {dict(b['counts'])}); per call (ms) {top}; B1 "
            f"{b1:.4f} ms, all kernels {b['total_ms']:.4f} ms against the step's events median "
            f"{t.median_ms:.4f} ms (min {t.min_ms:.4f}, max {t.max_ms:.4f}) and the card's own "
            f"time (queued windows) median {tc.median_ms:.4f} ms (min {tc.min_ms:.4f}, max "
            f"{tc.max_ms:.4f}; B1 {'within' if tc.min_ms <= b1 <= tc.max_ms else 'outside'} "
            f"it); a plain session (no throwaway before it) recorded B1 {b['plain_b1']} of "
            f"{b['counts']['mxu8_fused_kernel']} times and {b['plain_total']} of "
            f"{b['traced_total']} device activities")
    return lines


def phase_roofline(headline: dict):
    """``sda_tpu_torch.tools.bench_roofline.measure()`` at the headline's
    width with the breakdown: the full pipeline (B1 with fused
    reconstruction) and combine-only (B1) launches, each reveal checked,
    timed and held to the card's bound; the launches counted; the full
    pipeline's bound equal to the headline's."""
    from sda_tpu_torch.tools import bench_roofline as br
    from sda_tpu_torch.utils.profiling import _ATTEMPTS

    t0 = time.perf_counter()
    _reset_counts()
    art = br.measure(HEADLINE_DIM, HEADLINE_P, LANES, breakdown=True)
    counts = _counts()
    # each launch: its reveal call and WARMUP + ITERS timed calls; the
    # combine-only check adds one reconstruction; the breakdown one
    # untraced call and BREAKDOWN_ITERS traced ones in each of its sessions
    base = 2 * (1 + br.WARMUP + br.ITERS) + 1 + 1
    sessions = (counts["mxu8_fused"] - base) // br.BREAKDOWN_ITERS
    want = _only(mxu8_fused=base + sessions * br.BREAKDOWN_ITERS)
    if counts != want or not 1 <= sessions <= _ATTEMPTS:
        raise AssertionError(f"the roofline tool launched {counts}, not {want} with 1 to "
                             f"{_ATTEMPTS} traced sessions")
    full = art["full_pipeline"]
    if (full["bound_ms"], full["bound_by"]) != (headline["bound_ms"], headline["bound_by"]):
        raise AssertionError(f"the roofline tool's bound {full['bound_ms']} ms "
                             f"({full['bound_by']}) != the headline's {headline['bound_ms']} ms "
                             f"({headline['bound_by']})")
    path = br.write_artifact("ROOFLINE", art)
    return {"artifact": art, "launches": counts["mxu8_fused"], "sessions": sessions,
            "path": path, "s": time.perf_counter() - t0}


def phase_chacha_native():
    """``chacha.expand_masks`` on the card's host: which route it took, and
    the native expansion against numpy's (``chacha._expand_masks_numpy``),
    bit-equal, at 64 seeds x 1,000,002 and p = 2^63 - 871, and at 4 seeds x
    4,096 and p = 2^62 + 1, where about 1/4 of the draws are rejected (the
    numpy route's scalar path), each on the host clock."""
    import numpy as np

    from sda_tpu_torch import chacha

    rng = np.random.default_rng(71)
    res = {}
    for label, (n_seeds, dim, p) in CHACHA_NATIVE.items():
        seeds = [chacha.new_seed(128, rng) for _ in range(n_seeds)]
        before = dict(chacha.expansions)
        t0 = time.perf_counter()
        got = chacha.expand_masks(seeds, dim, p)
        t_route = time.perf_counter() - t0
        route = [name for name in before if chacha.expansions[name] != before[name]]
        t0 = time.perf_counter()
        want = chacha._expand_masks_numpy(seeds, dim, p)
        t_numpy = time.perf_counter() - t0
        if not np.array_equal(got, want):
            raise AssertionError(f"chacha expand_masks ({route}) != numpy at {label}")
        hits = int(np.count_nonzero(chacha._raw_draws(seeds[:1], dim)
                                    >= np.uint64((1 << 64) - 1 - ((1 << 64) - 1) % p)))
        res[label] = {"route": route, "ms": t_route * 1e3, "numpy_ms": t_numpy * 1e3,
                      "shape": f"{n_seeds} x {dim}", "first_seed_rejections": hits}
    return res


def phase_example():
    """``examples/bulk_aggregation_torch.py``'s ``main`` on the card at its
    defaults: its exit code must be 0 (the reveal equals the modular sum);
    its output lines, and that it launched no kernel."""
    import contextlib
    import importlib.util
    import io

    path = Path(__file__).resolve().parent / "examples" / "bulk_aggregation_torch.py"
    spec = importlib.util.spec_from_file_location("bulk_aggregation_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = _counted(lambda: example.main(["--device", "cuda"]), "the bulk example")
    lines = (err.getvalue() + out.getvalue()).strip().splitlines()
    if rc != 0:
        raise AssertionError(f"the bulk example exited {rc}: {lines}")
    return lines


def phase_scaling_artifact(drivers: dict, card: str, name: str):
    """``sda_tpu_torch.tools.make_scaling_artifact.compose`` on the
    ``drivers:`` phase's own config-5 row (no second run of the loop),
    written to ``build/measurements/SCALING.json``."""
    from sda_tpu_torch.tools import make_scaling_artifact as msa
    from sda_tpu_torch.tools._common import write_artifact

    real = {"platform": "gpu", "device": name, "card": card,
            "streaming_sharded": drivers["config5"]["row"]}
    art = msa.compose(real, None)
    return art, write_artifact("SCALING", art)


def _roofline_lines(rf: dict, h: dict, card: str, root: Path) -> list[str]:
    art = rf["artifact"]
    full, comb, t = art["full_pipeline"], art["combine_only"], h["timing"]
    parts = full["bound_parts_ms"]
    within = t.min_ms <= full["seconds"] * 1e3 <= t.max_ms
    return [
        f"roofline: bench_roofline.measure() {HEADLINE_P} x {HEADLINE_DIM}, lanes {LANES}, "
        f"--breakdown, on {card} ({full['card']} ceilings): full pipeline (B1 with fused "
        f"reconstruction) median {full['seconds'] * 1e3:.4f} ms (min {full['min_s'] * 1e3:.4f}, "
        f"max {full['max_s'] * 1e3:.4f}), the headline phase's {t.median_ms:.4f} ms (min "
        f"{t.min_ms:.4f}, max {t.max_ms:.4f}): {'within' if within else 'outside'} its "
        f"min-max; bound {full['bound_ms']:.4f} ms ({full['bound_by']}: bytes "
        f"{parts['bytes']:.4f}, int8 {parts['int8']:.4f}, Philox issue {parts['philox']:.4f}), "
        f"the headline's {h['bound_ms']:.4f} ms, {full['fraction_of_sol']:.4f} of it; "
        f"combine-only (B1) median {comb['seconds'] * 1e3:.4f} ms (min "
        f"{comb['min_s'] * 1e3:.4f}, max {comb['max_s'] * 1e3:.4f}), bound "
        f"{comb['bound_ms']:.4f} ms ({comb['bound_by']}), {comb['fraction_of_sol']:.4f} of it; "
        f"reveals exact",
        "roofline: breakdown (ms per call) "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in art["breakdown_ms"].items())
        + f"; B1 launches {rf['launches']} ({rf['sessions']} traced session(s)); "
          f"{rf['s']:.1f} s; wrote "
          f"{rf['path'].relative_to(root)}",
    ]


def _chacha_native_line(cn: dict, cr: dict, card: str) -> str:
    cases = "; ".join(
        f"{label}, {r['shape']}: route {'+'.join(r['route'])} {r['ms']:.4f} ms, numpy "
        f"{r['numpy_ms']:.4f} ms ({r['numpy_ms'] / r['ms']:.2f}x), bit-equal; first seed's "
        f"rejected draws {r['first_seed_rejections']}" for label, r in cn.items())
    return (f"chacha native: expand_masks on the host of {card}: {cases}; the chacha reveal's "
            f"combine on the host clock {cr['host_ms'][1]:.4f} ms (its expand_masks routes "
            f"{cr['expansions']}, bad seeds {cr['bad']})")


def _scaling_line(art: dict, path: Path, root: Path) -> str:
    pj = art["projected"]
    four, sens = pj["at_4_cards"], pj["nvlink_bandwidth_sensitivity"]
    return (
        f"scaling artifact: make_scaling_artifact.compose on the drivers: row "
        f"({pj['measured_chunk_s'] * 1e3:.4f} ms a chunk, local finish "
        f"{pj['finish_local_s'] * 1e3:.4f} ms, all-reduce payload "
        f"{pj['allreduce_payload_mb_per_card']:.6f} MB a card): projected {pj['cards']} cards "
        f"(100,000 x 1,000,002, {pj['chunks_per_card']} chunks a card, "
        f"{pj['assumptions']['nvlink_effective_gbps_per_card']:.0f} GB/s effective NVLink a "
        f"card, assumed): compute {pj['compute_s']:.4f} s, finish {pj['finish_s'] * 1e3:.4f} ms "
        f"(all-reduce {pj['allreduce_s'] * 1e3:.4f} ms), projected efficiency "
        f"{pj['weak_scaling_efficiency']:.4f}, {pj['aggregations_per_s']:.0f} aggregations/s "
        f"projected; efficiency at "
        + ", ".join(f"{g}: {v['weak_scaling_efficiency']:.4f}" for g, v in sens.items())
        + f" (projected); projected 4 cards: {four['chunks_per_card']} chunks a card, finish "
          f"{four['finish_s'] * 1e3:.4f} ms, efficiency {four['weak_scaling_efficiency']:.4f}; "
          f"wrote {path.relative_to(root)}")


def _device_ms_by_op(fn, iters: int = 5) -> dict:
    """Per-call device time (ms) of the kernels each torch op of ``fn``
    launched (its self device time), from the checked trace of
    ``profiling.profile_calls``; what ``device_breakdown`` cannot give. The
    port's kernels, launched through ctypes, belong to no torch op."""
    from torch.autograd import DeviceType

    from sda_tpu_torch.utils.profiling import profile_calls

    out = collections.Counter()
    for e in profile_calls(fn, iters)[0].key_averages():
        if e.device_type == DeviceType.CPU:
            out[e.key] += getattr(e, "self_device_time_total", 0) / 1e3 / iters
    return {name: ms for name, ms in out.most_common() if ms > 0}


def _mesh_lines(r: dict, card: str) -> list[str]:
    def pair(name):
        a, b = r[name]["mesh"], r[name]["engine"]
        return (f"mesh {a.median_ms:.4f} ms (min {a.min_ms:.4f}, max {a.max_ms:.4f}), engine "
                f"{b.median_ms:.4f} ms (min {b.min_ms:.4f}, max {b.max_ms:.4f})")

    def listed(name):
        return ", ".join(f"{n} {ms:.4f}" for n, ms in r[name].items())

    deg = ", ".join(f"without clerk {d} {t.median_ms:.4f} ms" for d, t in
                    zip(MESH["drops"], r["degraded"]))
    n7, n8 = MESH["stream7_chunks"], CONFIG4["n_chunks"]
    return [
        f"mesh: world 1 on NCCL, mesh {MESH_AXES}, {r['shape']} on {card}, {r['s']:.1f} s in "
        f"all; jnp step "
        f"({MESH['jnp_participants']} participants, no kernel): {pair('jnp')}; bit-equal to "
        f"engine.aggregate, reveal exact",
        f"mesh: gen-3 step (B6 x 2): {pair('gen3')} (engine: one B6 with fused reconstruction); "
        f"caller randomness {pair('gen3_ext')}, bit-equal to aggregate_mxu_kernel; stream "
        f"{n7} chunks (B6 x {n7 + 1}): {pair('gen3_stream')}; reveals exact",
        f"mesh: gen-4 step (B1 x 2): {pair('gen4')} (engine: one B1 with fused reconstruction); "
        f"config-4 stream {n8} x {HEADLINE_P} (B1 x 2 + B3 x {n8 - 1}): {pair('gen4_stream')}; "
        f"lane batch of 2 jobs (B1 x 2): {pair('lane_batch')} (engine: aggregate_mxu8_kernel_jobs, "
        f"one B1); caller randomness bit-equal to aggregate_mxu8_kernel and (2 chunks) "
        f"aggregate_mxu8_kernel_streaming; reveals exact",
        f"mesh: degraded finishes (B1 x 1 each, bit-equal to the full finish): {deg}; the "
        f"engine's reconstruct_planar8 {r['full_finish'].median_ms:.4f} ms",
        f"mesh: device time per step (torch.profiler, ms), by kernel (device_breakdown): gen-4 "
        f"step {listed('gen4_kernels_ms')}; gen-3 step {listed('gen3_kernels_ms')}; by torch op: "
        f"gen-4 step {listed('gen4_by_op_ms')}; gen-3 step {listed('gen3_by_op_ms')}",
    ]


def phase_crypto():
    """The port's sealed boxes and Ed25519 (``sda_tpu_torch/native/nacl.cpp``,
    built on this host with ``-march=native``) against RFC 7748 § 6.1, RFC
    8032 § 7.1 tests 1-3 and libsodium's own vectors (``SODIUM_BOX``,
    ``SODIUM_SIGS``), mutated signatures refused; then the host time per
    call of X25519, ``seal`` and ``seal_open`` of 1 KB and of one clerk's
    box at 1,000,002 / 3 values, ``sign_detached`` and ``verify_detached``."""
    import ctypes
    import ctypes.util

    import numpy as np

    from sda_tpu_torch import sodium
    from sda_tpu_torch.fields import find_special_prime_field
    from sda_tpu_torch.utils.varint import encode_varints

    t0 = time.perf_counter()
    lib = sodium._lib()
    load_s = time.perf_counter() - t0
    buf = ctypes.create_string_buffer
    wrong = []

    def check(ok: bool, what: str):
        if not ok:
            wrong.append(what)

    a, a_pub, b, b_pub, shared = (bytes.fromhex(x) for x in RFC7748)
    for sk, pub, other in ((a, a_pub, b_pub), (b, b_pub, a_pub)):
        q, s = buf(32), buf(32)
        check(lib.sda_x25519_base(q, sk) == 0 and q.raw == pub, "RFC 7748 public key")
        check(lib.sda_x25519(s, sk, other) == 0 and s.raw == shared, "RFC 7748 shared secret")
    for i, case in enumerate(RFC8032, 1):
        seed, pk, msg, sig = (bytes.fromhex(x) for x in case)
        vk, sk = buf(32), buf(64)
        lib.sda_sign_seed_keypair(vk, sk, seed)
        check(vk.raw == pk and sk.raw == seed + pk, f"RFC 8032 test {i} keys")
        check(sodium.sign_detached(msg, sk.raw) == sig, f"RFC 8032 test {i} signature")
        check(sodium.verify_detached(sig, msg, pk), f"RFC 8032 test {i} verification")
    bsk, esk, box = (bytes.fromhex(SODIUM_BOX[k]) for k in ("sk", "esk", "box"))
    msg = bytes(range(97))
    bpk, sealed = buf(32), buf(len(msg) + sodium.SEALBYTES)
    lib.sda_x25519_base(bpk, bsk)
    check(lib.sda_box_seal(sealed, msg, len(msg), bpk.raw, esk) == 0 and sealed.raw == box,
          "libsodium's sealed box")
    check(sodium.seal_open(box, bpk.raw, bsk) == msg, "libsodium's sealed box opened")
    refused = 0
    for seed, pk, n, sig in SODIUM_SIGS:
        seed, pk, sig = (bytes.fromhex(x) for x in (seed, pk, sig))
        m = bytes(range(n))
        vk, sk = buf(32), buf(64)
        lib.sda_sign_seed_keypair(vk, sk, seed)
        check(vk.raw == pk and sodium.sign_detached(m, sk.raw) == sig, "libsodium's signature")
        check(sodium.verify_detached(sig, m, pk), "libsodium's signature verified")
        s = int.from_bytes(sig[32:], "little")
        for bad_sig, bad_pk in ((sig[:32] + (s + ED25519_L).to_bytes(32, "little"), pk),
                                (bytes([sig[0] ^ 1]) + sig[1:], pk),
                                (bytes.fromhex(SMALL_ORDER_Y8) + bytes(32), pk),
                                (sig, bytes([1]) + bytes(31))):
            check(not sodium.verify_detached(bad_sig, m, bad_pk), "a mutated signature accepted")
            refused += 1
    if wrong:
        raise AssertionError(f"the port's crypto on this host: {', '.join(wrong)}")

    def per_call_ms(fn, n: int) -> float:
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    rng = np.random.default_rng(72)
    p = find_special_prime_field(63, 8, 9)[0]
    clerk = encode_varints(rng.integers(0, p, size=-(-HEADLINE_DIM // 3), dtype=np.int64))
    ek, dk = sodium.box_keypair()
    q = buf(32)
    ms = {"x25519": per_call_ms(lambda: lib.sda_x25519(q, a, b_pub), 200)}
    for label, m, n in (("1 KB", rng.bytes(1024), 200),
                        (f"one clerk's box ({len(clerk):,} B)", clerk, 10)):
        box_m = sodium.seal(m, ek)
        ms[f"seal {label}"] = per_call_ms(lambda: sodium.seal(m, ek), n)
        ms[f"seal_open {label}"] = per_call_ms(lambda: sodium.seal_open(box_m, ek, dk), n)
    vk, sk = sodium.sign_keypair()
    m = rng.bytes(200)
    sig = sodium.sign_detached(m, sk)
    ms["sign_detached (200 B)"] = per_call_ms(lambda: sodium.sign_detached(m, sk), 200)
    ms["verify_detached (200 B)"] = per_call_ms(lambda: sodium.verify_detached(sig, m, vk), 200)
    return {"ms": ms, "refused": refused, "load_s": load_s, "library": Path(lib._name).name,
            "find_library": ctypes.util.find_library("sodium")}


def _loop_pass(dimension: int, participants: int, masking: str, workers: int,
               all_bulk: bool, stages=None, tamper=None, retry=None, forged_dimension=None,
               device=None) -> dict:
    """One pass of ``bench.py:_bench_system_e2e``'s ``run_loop`` on the port:
    a recipient, 8 clerks (``device_bulk_threshold=1``, the bulk route) on a
    deterministic committee and up to 8 participant agents, packed Shamir
    (3 secrets, 8 shares, threshold 4) at ``find_special_prime_field(63, 8,
    9)``, ``serve_background`` over a jsondir store in a temporary directory.
    With ``all_bulk`` every client
    takes the bulk route: the participants share with ``share_mxu`` and the
    recipient reconstructs on the card. Build, ingest, snapshot, drain and
    reveal on the host clock; the reveal's launches, the clerks' combine
    routes and the devices of the clients' engines.

    The degraded committee (``TOLERANCE``): ``retry`` is a participant whose
    participation is uploaded twice; ``tamper`` = (participant, clerk) flips
    one byte of that participant's box for that clerk before the upload,
    and the clerk then processes its job once (it must raise ``Invalid``)
    and polls it again; ``stages`` are the committee indices that drain,
    stage by stage (all 8 at once by default), each followed by the
    snapshot's status and, while it is not ready, a refused reveal;
    ``forged_dimension`` adds an aggregation of that width whose last clerk
    key carries a signature with one bit flipped, at which a participation
    must be refused. ``device`` is every client's device (the card unless
    ``"cpu"``). Only the ``Invalid`` of a refusal is caught; its type and
    message are returned for ``_tolerance_failures``."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from sda_tpu_torch import client as client_mod
    from sda_tpu_torch import protocol as proto
    from sda_tpu_torch.client import Keystore, MemoryStore, SdaClient, new_agent
    from sda_tpu_torch.client.crypto import ShareDecryptor
    from sda_tpu_torch.fields import find_special_prime_field
    from sda_tpu_torch.http import HttpSdaService, serve_background
    from sda_tpu_torch.server import new_jsondir_server
    from sda_tpu_torch.utils.errors import Invalid

    def refused(fn) -> str | None:
        """The message of the ``Invalid`` that ``fn`` raises, else None."""
        try:
            fn()
        except Invalid as e:
            return f"{type(e).__name__}: {e}"
        return None

    p, w2, w3 = find_special_prime_field(63, 8, 9)
    sharing = proto.PackedShamirSharing(secret_count=3, share_count=8, privacy_threshold=4,
                                        prime_modulus=p, omega_secrets=w2, omega_shares=w3)

    def masking_scheme(d: int):
        return (proto.ChaChaMasking(modulus=p, dimension=d, seed_bitsize=128)
                if masking == "chacha" else proto.NoMasking())

    stages = stages or (tuple(range(8)),)
    tmp = tempfile.mkdtemp(prefix="sda-loop-")
    try:
        with serve_background(new_jsondir_server(tmp)) as url:
            def mk(threshold=None):
                ks = Keystore(MemoryStore())
                return SdaClient(new_agent(ks), ks, HttpSdaService(url, MemoryStore()),
                                 device_bulk_threshold=threshold, device=device)

            def status():
                st = recipient.service.get_aggregation_status(recipient.agent, agg.id)
                snap = st.snapshots[0] if st.snapshots else None
                return {"participations": st.number_of_participations,
                        "results": snap.number_of_clerking_results if snap else None,
                        "ready": snap.result_ready if snap else None}

            bulk = 1 if all_bulk else None
            recipient = mk(bulk)
            rkey = recipient.new_encryption_key()
            recipient.upload_agent()
            recipient.upload_encryption_key(rkey)
            agg = proto.Aggregation(
                id=proto.new_id(), title="full loop", vector_dimension=dimension, modulus=p,
                recipient=recipient.agent.id, recipient_key=rkey,
                masking_scheme=masking_scheme(dimension), committee_sharing_scheme=sharing,
            )
            recipient.upload_aggregation(agg)
            clerks = [mk(1) for _ in range(8)]
            keys = []
            for c in clerks:
                keys.append(c.new_encryption_key())
                c.upload_agent()
                c.upload_encryption_key(keys[-1])
            # the committee is exactly the 8 clerks: the service's suggestion
            # may seat the recipient, who drains no job
            recipient.service.create_committee(recipient.agent, proto.Committee(
                aggregation=agg.id,
                clerks_and_keys=tuple((c.agent.id, k) for c, k in zip(clerks, keys))))

            rng = np.random.default_rng(17)
            secrets = rng.integers(0, 1 << 62, size=(participants, dimension),
                                   dtype=np.int64) % p
            expect = [int(x) for x in secrets.astype(object).sum(axis=0) % p]
            agents = [mk(bulk) for _ in range(min(8, participants))]
            for c in agents:
                c.upload_agent()

            def run(fn):
                t0 = time.perf_counter()
                with ThreadPoolExecutor(max_workers=workers) as ex:
                    out = list(ex.map(fn, range(participants)))
                return out, time.perf_counter() - t0

            parts, t_build = run(lambda i: agents[i % len(agents)].new_participation(
                secrets[i], agg.id))
            wire = sum(len(e.data) for part in parts for _, e in part.clerk_encryptions)
            wire += sum(len(part.recipient_encryption.data) for part in parts
                        if part.recipient_encryption is not None)
            tampered = None
            if tamper is not None:
                who, ci = tamper
                encs = list(parts[who].clerk_encryptions)
                clerk_id, enc = encs[ci]
                data = bytearray(enc.data)
                data[len(data) // 2] ^= 0xFF
                encs[ci] = (clerk_id, proto.Encryption(data=bytes(data)))
                tampered = {"clerk": ci, "box": bytes(data), "original": enc.data}
                parts[who] = dataclasses.replace(parts[who], clerk_encryptions=tuple(encs))
            _, t_ingest = run(lambda i: agents[i % len(agents)].upload_participation(parts[i]))
            t_retry = None
            if retry is not None:
                t0 = time.perf_counter()
                agents[retry % len(agents)].upload_participation(parts[retry])
                t_retry = time.perf_counter() - t0
            t0 = time.perf_counter()
            recipient.end_aggregation(agg.id)
            t_snapshot = time.perf_counter() - t0
            after_snapshot = status()

            before = dict(client_mod.combine_routes)
            if tampered is not None:
                clerk = clerks[tampered["clerk"]]
                t0 = time.perf_counter()
                job = clerk.service.get_clerking_job(clerk.agent, clerk.agent.id)
                opened = []
                real_open = ShareDecryptor.open_combine

                def traced_open(self, *a, **kw):
                    opened.append(1)
                    return real_open(self, *a, **kw)

                ShareDecryptor.open_combine = traced_open
                try:
                    error = refused(lambda: clerk.process_clerking_job(job))
                finally:
                    ShareDecryptor.open_combine = real_open
                again = clerk.service.get_clerking_job(clerk.agent, clerk.agent.id)
                tampered.update(
                    s=time.perf_counter() - t0, error=error, fused_calls=len(opened),
                    job=job.id, polled_again=again.id if again is not None else None,
                    boxes=sum(e.data == tampered["box"] for e in job.encryptions),
                    after=status())

            drain = []
            t_drain = 0.0
            drained = 0
            for stage in stages:
                t0 = time.perf_counter()
                n = sum(1 for i in stage for _ in iter(clerks[i].clerk_once, False))
                s_stage = time.perf_counter() - t0
                t_drain += s_stage
                drained += n
                st = status()
                st.update(clerks=tuple(stage), drained=n, s=s_stage, refused=None)
                if not st["ready"]:
                    st["refused"] = refused(lambda: recipient.reveal_aggregation(agg.id))
                drain.append(st)
            routes = {k: n - before[k] for k, n in client_mod.combine_routes.items()}

            reconstructions = []
            real_reconstruct = recipient._device_reconstruct

            def traced_reconstruct(scheme, indexed_shares, dim):
                reconstructions.append({"indices": [i for i, _ in sorted(
                    indexed_shares, key=lambda t: t[0])], "scheme": scheme,
                    "shares": list(indexed_shares)})
                return real_reconstruct(scheme, indexed_shares, dim)

            recipient._device_reconstruct = traced_reconstruct
            _reset_counts()
            t0 = time.perf_counter()
            revealed = recipient.reveal_aggregation(agg.id).positive()
            if torch.device(device or DEVICE).type == "cuda":
                torch.cuda.synchronize()
            t_reveal = time.perf_counter() - t0
            launches = {**_counts(), **_chacha_counts()}

            if tampered is not None:
                # the tampered clerk's own combined share over the boxes as
                # they were sealed, for the full-set reconstruction
                clerk = clerks[tampered["clerk"]]
                job = clerk.service.get_clerking_job(clerk.agent, clerk.agent.id)
                boxes = [proto.Encryption(data=tampered["original"])
                         if e.data == tampered["box"] else e for e in job.encryptions]
                decryptor = clerk.crypto.new_share_decryptor(keys[tampered["clerk"]],
                                                             agg.committee_encryption_scheme)
                tampered["share"] = decryptor.open_combine(boxes, p, -(-dimension // 3))
                tampered["still_polled"] = job.id

            forged = None
            if forged_dimension is not None:
                forger = mk(1)
                forger.upload_agent()
                key_id = forger.crypto.new_encryption_key()
                signed = forger.crypto.sign_export(forger.agent, key_id)
                sig = bytearray(signed.signature.data)
                sig[0] ^= 0x01
                forger.service.create_encryption_key(forger.agent, proto.Signed(
                    signature=proto.Signature(bytes(sig)), signer=signed.signer,
                    body=signed.body))
                agg2 = dataclasses.replace(agg, id=proto.new_id(), title="forged key",
                                           vector_dimension=forged_dimension,
                                           masking_scheme=masking_scheme(forged_dimension))
                recipient.upload_aggregation(agg2)
                recipient.service.create_committee(recipient.agent, proto.Committee(
                    aggregation=agg2.id,
                    clerks_and_keys=tuple((c.agent.id, k) for c, k in zip(clerks[:7], keys))
                    + ((forger.agent.id, key_id),)))
                forged = refused(lambda: agents[0].new_participation(
                    secrets[0, :forged_dimension], agg2.id))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "exact": revealed.values.tolist() == expect, "drained": drained, "routes": routes,
        "launches": {k: n for k, n in launches.items() if n},
        "engines": {"sharing": sorted({e.device.type for c in agents
                                       for e in c._engines.values()}),
                    "reconstruction": sorted({e.device.type
                                              for e in recipient._engines.values()})},
        "s": {"build": t_build, "ingest": t_ingest, "snapshot": t_snapshot,
              "drain": t_drain, "reveal": t_reveal},
        "wire_mb": wire / 1e6, "participants": participants,
        "dimension": dimension, "after_snapshot": after_snapshot, "retry_s": t_retry,
        "tampered": tampered, "stages": drain, "reconstructions": reconstructions,
        "forged": forged, "recipient": recipient, "modulus": p,
    }


def phase_full_loop():
    """The protocol loop on the card (``FULL_LOOP``): pass A, 1,000 x 1,002
    under ChaCha masking over HTTP, whose reveal must be exact, launch B5
    exactly once and B4 never, after every clerk job took the fused native
    open + combine; pass B, 8 x 1,000,002 with no masking and every client
    on the bulk route, whose reveal must be exact with the sharing and the
    reconstruction on the card. Then B5 alone at pass A's reveal shape,
    timed with CUDA events."""
    import numpy as np
    import torch

    from sda_tpu_torch import chacha
    from sda_tpu_torch.fields import find_special_prime_field
    from sda_tpu_torch.ops import chacha_kernel as ck
    from sda_tpu_torch.utils.profiling import cuda_time

    out = {}
    for name, cfg in FULL_LOOP.items():
        r = _loop_pass(**cfg)
        shape = f"{cfg['participants']:,} x {cfg['dimension']:,}"
        if not r["exact"]:
            raise AssertionError(f"full loop {name} ({shape}): the reveal != the sum mod p")
        if r["drained"] != 8 or r["routes"] != {"fused": 8, "device": 0, "sequential": 0}:
            raise AssertionError(f"full loop {name}: {r['drained']} clerk jobs drained, routes "
                                 f"{r['routes']}: not 8 on the fused native open + combine")
        want = {"chacha_fold": 1} if cfg["masking"] == "chacha" else {}
        if r["launches"] != want:
            raise AssertionError(f"full loop {name}: the reveal launched {r['launches']}, "
                                 f"not {want}")
        if cfg["all_bulk"] and (r["engines"]["sharing"] != ["cuda"]
                                or r["engines"]["reconstruction"] != ["cuda"]):
            raise AssertionError(f"full loop {name}: engines on {r['engines']}, not the card")
        out[name] = r
    cfg = FULL_LOOP["A"]
    p = find_special_prime_field(63, 8, 9)[0]
    rng = np.random.default_rng(73)
    seeds = [chacha.new_seed(128, rng) for _ in range(cfg["participants"])]
    keys = ck._key_tensor(seeds, torch.device(DEVICE))
    out["b5"] = cuda_time(lambda i: ck._launch_fold(keys, cfg["dimension"], p), iters=20)
    return out


def _tolerance_failures(r: dict, cfg: dict) -> list[str]:
    """What a ``_loop_pass`` run of the degraded committee (``cfg``, as
    ``TOLERANCE``) got wrong, on any device: the retried participation
    counted once; the tampered clerk's job refused by the fused native open +
    combine with ``Invalid``, no result stored, the job polled again under
    its id; each stage's results and readiness, the not-ready reveal
    refused; the reveal exact through the recipient's subset branch of the
    drained clerks; the forged key refused."""
    wrong = []

    def want(got, expected, what: str):
        if got != expected:
            wrong.append(f"{what}: {got!r}, not {expected!r}")

    want(r["after_snapshot"]["participations"], cfg["participants"],
         "participations after the retry")
    t = r["tampered"]
    want(t["error"], "Invalid: sodium seal_open failure (tampered or wrong key)",
         "the tampered clerk's job")
    want(t["fused_calls"], 1, "the tampered job's fused open + combine calls")
    want(t["boxes"], 1, "tampered boxes in the job")
    want(t["after"]["results"], 0, "results stored after the tampered job")
    want(t["polled_again"], t["job"], "the tampered job polled again")
    want(t["still_polled"], t["job"], "the tampered job polled after the reveal")
    drained = []
    threshold = 7  # t + k of packed Shamir 3/8/4
    for st, stage in zip(r["stages"], cfg["stages"]):
        drained += stage
        n = len(drained)
        want(st["drained"], len(stage), f"jobs drained by clerks {stage}")
        want((st["results"], st["ready"]), (n, n >= threshold), f"the snapshot after {n} results")
        want(st["refused"], None if n >= threshold else "Invalid: Aggregation not ready",
             f"the reveal at {n} results")
    want(r["routes"], {"fused": len(drained), "device": 0, "sequential": 0},
         "the drained jobs' combine routes")
    want(r["exact"], True, "the reveal equals the sum mod p")
    want([c["indices"] for c in r["reconstructions"]], [sorted(drained)],
         "the recipient's device reconstruction")
    want(r["forged"], "Invalid: Signature verification failed for key",
         f"the participation at {cfg['forged_dimension']:,} with a forged clerk key")
    return wrong


def phase_tolerance():
    """The degraded committee on the card (``TOLERANCE``): 4 participants x
    1,000,002 under ChaCha masking, every client on the bulk route, over
    HTTP. It fails unless every ``_tolerance_failures`` check holds, the
    reveal launched ``TOLERANCE_LAUNCHES`` and the sharing and the
    reconstruction ran on the card. Then, with CUDA events on the same
    combined shares, the subset reconstruction (``modmat`` on the 7 drained
    clerks' Lagrange matrix) against the full set (``engine.reconstruct``
    with the tampered clerk's own combined share), their outputs equal; and
    the reveal's ChaCha combine at 4 seeds on the chunk route (B4) against
    the fused route (B5 and its fix-up), their results equal."""
    import numpy as np
    import torch

    from sda_tpu_torch import chacha
    from sda_tpu_torch.ops import chacha_kernel as ck
    from sda_tpu_torch.ops.modmat import modmat
    from sda_tpu_torch.utils.profiling import cuda_time

    cfg = TOLERANCE
    t0 = time.perf_counter()
    r = _loop_pass(**cfg)
    r["s_all"] = time.perf_counter() - t0
    wrong = _tolerance_failures(r, cfg)
    if r["launches"] != TOLERANCE_LAUNCHES:
        wrong.append(f"the reveal launched {r['launches']}, not {TOLERANCE_LAUNCHES}")
    on = [torch.device(DEVICE).type]
    if r["engines"] != {"sharing": on, "reconstruction": on}:
        wrong.append(f"engines on {r['engines']}, not {on}")
    if wrong:
        raise AssertionError("tolerance: " + "; ".join(wrong))

    rec = r["reconstructions"][0]
    scheme, d, p = rec["scheme"], cfg["dimension"], r["modulus"]
    eng = r["recipient"]._bulk_engine(scheme, d)
    sub = sorted(rec["shares"], key=lambda t: t[0])
    full = sorted(sub + [(r["tampered"]["clerk"], r["tampered"]["share"])], key=lambda t: t[0])

    def limbs(shares):
        return eng.ctx.encode_i64(np.asarray([v for _, v in shares], dtype=np.int64).T,
                                  eng.device)

    a_sub, a_full = limbs(sub), limbs(full)
    mat = eng.ctx.encode_mont(np.asarray(scheme.reconstruct_matrix([i for i, _ in sub]),
                                         dtype=object), eng.device)
    if not torch.equal(modmat(eng.ctx, a_sub, mat), eng.reconstruct(a_full)):
        raise AssertionError("tolerance: the subset and the full-set reconstruction differ")
    r["subset"] = cuda_time(lambda i: modmat(eng.ctx, a_sub, mat), iters=10)
    r["full"] = cuda_time(lambda i: eng.reconstruct(a_full), iters=10)
    r["rows"] = int(a_sub.shape[0])

    rng = np.random.default_rng(74)
    seeds = [chacha.new_seed(128, rng) for _ in range(cfg["participants"])]
    dev = torch.device(DEVICE)
    chunk = np.asarray(ck.combine_masks_device(seeds, d, p, device=DEVICE)[0], dtype=np.int64)
    fused = np.asarray(ck._combine_fused(seeds, d, p, True, dev)[0], dtype=np.int64)
    if not np.array_equal(chunk, fused):
        raise AssertionError("tolerance: B4's chunk route and B5's fused route differ at 4 seeds")
    r["chunk_route"] = cuda_time(lambda i: ck.combine_masks_device(seeds, d, p, device=DEVICE),
                                 iters=5)
    r["fused_route"] = cuda_time(lambda i: ck._combine_fused(seeds, d, p, True, dev), iters=5)
    return r


def _tolerance_lines(r: dict, card: str) -> list[str]:
    cfg, s, t = TOLERANCE, r["s"], r["tampered"]
    st = r["stages"]
    stages = ", ".join(f"clerks {c['clerks'][0]}-{c['clerks'][-1]} {c['s']:.3f} s"
                       if len(c["clerks"]) > 1 else f"clerk {c['clerks'][0]} {c['s']:.3f} s"
                       for c in st)
    launches = ", ".join(f"{k} x {n}" for k, n in r["launches"].items())

    def timed(x) -> str:
        return f"median {x.median_ms:.4f} ms (min {x.min_ms:.4f}, max {x.max_ms:.4f})"

    return [
        f"tolerance: {cfg['participants']} participants x {cfg['dimension']:,} "
        f"({cfg['masking']} masking, packed Shamir 3/8/4 at 2^63 - 871, 8 clerks, every client "
        f"on the bulk route, {cfg['workers']} workers) over HTTP (jsondir store) on {card}: "
        f"build {s['build']:.3f} s, ingest {s['ingest']:.3f} s, retry "
        f"{r['retry_s'] * 1e3:.1f} ms, snapshot {s['snapshot'] * 1e3:.1f} ms, tampered clerk "
        f"{t['s'] * 1e3:.1f} ms, {stages}, reveal {s['reveal'] * 1e3:.1f} ms; wire "
        f"{r['wire_mb']:.3f} MB; {r['s_all']:.1f} s in all",
        f"tolerance: checks on {card}: participant 0's retry counted once "
        f"({r['after_snapshot']['participations']} participations); clerk {t['clerk']}'s job on "
        f"the fused native open + combine raised {t['error']}, {t['after']['results']} results "
        f"stored, job {t['job'][:8]} polled again; {st[0]['results']} results: result_ready "
        f"{st[0]['ready']}, reveal raised {st[0]['refused']}; {st[1]['results']} results: "
        f"result_ready {st[1]['ready']}; reveal exact through the subset branch "
        f"{r['reconstructions'][0]['indices']} on {r['engines']['reconstruction'][0]}, sharing "
        f"on {r['engines']['sharing'][0]} (share_mxu); the reveal launched {launches} "
        f"(4 seeds: the chunk route; B5 x {r['launches'].get('chacha_fold', 0)}); forged clerk "
        f"key at {cfg['forged_dimension']:,}: {r['forged']}; all pass",
        f"tolerance: reconstruction at {r['rows']:,} rows on {card}, CUDA events, same combined "
        f"shares: subset (7 of 8, modmat on the subset's Lagrange matrix) {timed(r['subset'])}; "
        f"full set (engine.reconstruct, 8) {timed(r['full'])}; outputs equal; the reveal's "
        f"ChaCha combine at {cfg['participants']} seeds x {cfg['dimension']:,}: chunk route "
        f"(B4 + torch, the call) {timed(r['chunk_route'])}, fused route (B5 + fix-up, the call) "
        f"{timed(r['fused_route'])}, equal",
    ]


def phase_cli():
    """The README walkthrough as processes: ``python -m
    sda_tpu_torch.server_cli --jfs <tmp> httpd -b 127.0.0.1:0`` and each
    ``python -m sda_tpu_torch.cli`` call of ``tests/test_torch_cli.py``; the
    reveal must be ``CLI_REVEAL``. The server started here, and only it, is
    stopped at the end."""
    import shutil
    import subprocess
    import tempfile

    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="sda-cli-"))
    log = tmp / "server.log"
    t0 = time.perf_counter()
    with open(log, "w") as err:
        server = subprocess.Popen(
            [sys.executable, "-m", "sda_tpu_torch.server_cli", "--jfs", str(tmp / "server"),
             "httpd", "-b", "127.0.0.1:0"], cwd=root, stdout=subprocess.DEVNULL, stderr=err)
    calls = []
    try:
        deadline = time.monotonic() + 120
        while (found := re.search(r"Starting server on (\S+)", log.read_text())) is None:
            if server.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"the CLI server did not start: {log.read_text()[-2000:]}")
            time.sleep(0.1)
        url = found.group(1)

        def sda(ident: str, *args) -> str:
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "sda_tpu_torch.cli", "-s", url, "-i",
                 str(tmp / "agent" / ident), *map(str, args)],
                cwd=root, capture_output=True, text=True, timeout=300)
            calls.append(time.perf_counter() - t)
            if proc.returncode != 0:
                raise AssertionError(f"sda -i {ident} {' '.join(map(str, args))} exited "
                                     f"{proc.returncode}: {proc.stderr[-2000:]}")
            return proc.stdout

        for ident in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
            sda(ident, "agent", "create")
            sda(ident, "agent", "keys", "create")
        for ident in ("part-1", "part-2", "part-3"):
            sda(ident, "agent", "create")
        key_id = sda("recipient", "agent", "keys", "show").strip().splitlines()[0]
        aggid = "ad3142d8-9a83-4f40-a64a-a8c90b701bde"
        sda("recipient", "aggregations", "create", "--id", aggid, "aggro", 10, 433, key_id, 3)
        sda("recipient", "aggregations", "begin", aggid)
        sda("part-1", "participate", aggid, *range(10))
        sda("part-2", "participate", aggid, *[0] * 10)
        sda("part-3", "participate", aggid, *[0, 1] * 5)
        sda("recipient", "aggregations", "end", aggid)
        for ident in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
            sda(ident, "clerk", "--once")
        out = sda("recipient", "aggregations", "reveal", aggid)
        got = re.search(r"result: ([0-9 ]+)", out)
        if got is None or got.group(1).strip() != CLI_REVEAL:
            raise AssertionError(f"the CLI walkthrough revealed {out.strip()!r}, not {CLI_REVEAL}")
    finally:
        server.terminate()
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    return {"s": time.perf_counter() - t0, "calls": calls, "reveal": got.group(1).strip()}


def phase_crossover():
    """``sda_tpu_torch.tools.measure_combine_crossover.measure()`` on the card
    at the tool's shapes: the fused native open + combine against the
    streamed device route, their results equal; written to
    ``build/measurements/CROSSOVER.json``."""
    from sda_tpu_torch import client as client_mod
    from sda_tpu_torch.tools import measure_combine_crossover as mcc
    from sda_tpu_torch.tools._common import write_artifact

    t0 = time.perf_counter()
    art = mcc.measure(device=DEVICE)
    s = time.perf_counter() - t0
    return {"artifact": art, "path": write_artifact("CROSSOVER", art), "s": s,
            "constant": client_mod.DEVICE_COMBINE_CROSSOVER}


def _crypto_line(cr: dict, card: str) -> str:
    times = ", ".join(f"{k} {v:.4f} ms" for k, v in cr["ms"].items())
    return (f"crypto: sda_tpu_torch/native/nacl.cpp ({cr['library']}, -O3 -march=native, ready in "
            f"{cr['load_s']:.1f} s) on the host of {card}; find_library('sodium') = "
            f"{cr['find_library']!r}; RFC 7748 § 6.1 (both public keys, the shared secret both "
            f"ways), RFC 8032 § 7.1 tests 1-3 (keys, signatures, verification), libsodium's sealed "
            f"box (byte-equal with its ephemeral key, opened) and {len(SODIUM_SIGS)} signatures "
            f"(byte-equal, verified), {cr['refused']} mutated signatures refused: all pass; per "
            f"call on the host clock: {times}")


def _loop_lines(fl: dict, card: str) -> list[str]:
    lines = []
    for name, r in fl.items():
        if name == "b5":
            continue
        s, n = r["s"], r["participants"]
        checks = ("B5 x 1 and B4 x 0 in the reveal" if name == "A" else
                  f"sharing on {r['engines']['sharing'][0]} (share_mxu), reconstruction on "
                  f"{r['engines']['reconstruction'][0]}")
        lines.append(
            f"full loop: {name} {n:,} participants x {r['dimension']:,} "
            f"({FULL_LOOP[name]['masking']} masking, {FULL_LOOP[name]['workers']} workers) over "
            f"HTTP (jsondir store) on {card}: build {s['build']:.3f} s "
            f"({n / s['build']:.1f} participations/s), ingest {s['ingest']:.3f} s, snapshot "
            f"{s['snapshot'] * 1e3:.1f} ms, drain {s['drain']:.3f} s "
            f"({n / s['drain']:.1f} participations/s, 8 clerk jobs), reveal "
            f"{s['reveal'] * 1e3:.1f} ms; wire {r['wire_mb']:.3f} MB; {sum(s.values()):.1f} s in "
            f"all; reveal exact; 8 clerk jobs on the fused native open + combine; {checks}")
    t = fl["b5"]
    lines.append(f"full loop: B5 at pass A's reveal ({FULL_LOOP['A']['participants']:,} seeds x "
                 f"{FULL_LOOP['A']['dimension']:,}) on {card}: median {t.median_ms:.4f} ms (min "
                 f"{t.min_ms:.4f}, max {t.max_ms:.4f}), CUDA events")
    return lines


def _cli_line(cl: dict, card: str) -> str:
    c = sorted(cl["calls"])
    return (f"cli: README walkthrough (server_cli httpd + {len(c)} sda processes) on the host of "
            f"{card}: result {cl['reveal']}; {cl['s']:.1f} s in all, a call median "
            f"{c[len(c) // 2]:.3f} s (min {c[0]:.3f}, max {c[-1]:.3f})")


def _crossover_line(co: dict, card: str, root: Path) -> str:
    art = co["artifact"]
    rows = "; ".join(f"{r['boxes']} x {r['elements_per_box']}: fused {r['fused_native_s']:.4f} s, "
                     f"device {r['streamed_device_s']:.4f} s ({r['winner']})" for r in art["rows"])
    return (f"tool combine crossover: on {card}, host clock: {rows}; crossover "
            f"{art['observed_crossover_elements']} elements (DEVICE_COMBINE_CROSSOVER stays "
            f"{co['constant']:,}); {co['s']:.1f} s; wrote {co['path'].relative_to(root)}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "sda_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))

    from sda_tpu_torch.utils.profiling import card_line, max_sm_mhz

    card = card_line()
    name = torch.cuda.get_device_name(0)
    build_s, ptxas = phase_build()
    print(f"build: {build_s:.1f} s (nvcc, sm_90a, {len(ptxas)} variants in parallel)", flush=True)
    for variant, summary in ptxas.items():
        print(f"build: ptxas registers {variant}: {summary}", flush=True)
    from sda_tpu_torch.ops.cuda_build import ptxas_report

    variants = _variants()
    for variant in ("mxu8_fused", "mxu8_acc", "mxu8_chunked", "mxu7_fused", "planar_cios"):
        spills = _ptxas_spills(ptxas_report(*variants[variant]))
        listed = " ".join(f"{k}:{regs} registers/{sp} B spilled"
                          for k, (regs, sp) in spills.items())
        print(f"build: ptxas spills {variant}: {listed}", flush=True)
        kept = KEPT_PTXAS.get(variant)
        if kept is not None:
            now = tuple(spills.get(f"MT{mt}") for mt in range(1, 13))
            diff = [f"MT{mt}: {was} -> {got}" for mt, (was, got) in enumerate(zip(kept, now), 1)
                    if got != was]
            print(f"build: ptxas {variant} MT1-MT12 against the counts it was measured with "
                  f"(PERF.md § 6): {'equal' if not diff else 'CHANGED ' + ', '.join(diff)}",
                  flush=True)
            if diff:
                raise AssertionError(f"{variant}'s ptxas registers/spills moved from KEPT_PTXAS: "
                                     + ", ".join(diff))
    from sda_tpu_torch.ops.chacha_kernel import KERNEL_VARIANTS as CHACHA_VARIANTS

    from sda_tpu_torch.ops.sass import sass_listing

    sass = {**sass_listing(*CHACHA_VARIANTS["chacha"]), **sass_listing(*variants["planar_cios"]),
            "MT5": sass_listing(*variants["mxu7_fused"])["MT5"],
            "mxu8 MT4": sass_listing(*variants["mxu8_fused"])["MT4"]}  # the headline's
    for kernel, instrs in sass.items():
        top = ", ".join(f"{op} {n}" for op, n in _opcode_counts(instrs).most_common(6))
        print(f"build: sass {kernel}: {len(instrs)} instructions ({top})", flush=True)

    cases, cmp_err, mid = phase_compare()
    print(f"compare: {cases} kernel/plain cases bit-equal at the mid shape ({mid['shape']}): "
          f"kernel {mid['kernel_ms']:.4f} ms, plain (CPU) {mid['plain_cpu_ms']:.1f} ms", flush=True)
    cases2, cmp_err2 = phase_compare_chunked()
    print(f"compare: B2 {cases2['mxu8_chunked']} cases (2 and 3 chunks, with the streaming-loop "
          f"check) and B3 {cases2['mxu8_acc']} cases bit-equal at the mid shape", flush=True)
    ring_cases, ring_err = phase_compare_ring()
    print(f"compare: ring cases ({len(RING_CASES)} shapes: K below one tile, below the ring, not "
          f"a multiple of 64; rp=1, 4 and 7; 128-bit; NBP past the last block; 4-byte and byte "
          f"copies; ones row inside the MMA's tiles) and {len(WIDE_CASES)} wide plans (MT 12 and "
          f"MT 11 with PRNG and reconstruction; more outputs than clerks): B1 "
          f"{ring_cases['mxu8_fused']}, B2 (3 chunks; S = the card's choice, 1, 2, 5 and the "
          f"tiles + 3) {ring_cases['mxu8_chunked']}, B3 {ring_cases['mxu8_acc']} cases bit-equal",
          flush=True)
    cmp_err = max(cmp_err, ring_err["mxu8_fused"])
    for kernel in ("mxu8_chunked", "mxu8_acc"):
        cmp_err2[kernel] = max(cmp_err2[kernel], ring_err[kernel])

    mhz = max_sm_mhz()
    h = phase_headline(mhz)
    t = h["timing"]
    print(f"headline: {h['shape']} on {card}: median {t.median_ms:.4f} ms "
          f"(min {t.min_ms:.4f}, max {t.max_ms:.4f}, {len(t.samples_ms)} steps), "
          f"{HEADLINE_P / (t.median_ms / 1e3):.0f} aggregations/s; bound {h['bound_ms']:.4f} ms "
          f"({h['bound_by']}: bytes {h['parts']['bytes']:.4f}, int8 {h['parts']['int8']:.4f}, "
          f"Philox issue {h['parts']['philox']:.4f} at {h['philox_call_ops']} SASS instructions "
          f"per call); plain on card {h['plain_ms']:.1f} ms; launches {h['launches']}; "
          f"{_launch_text(h['launch'])}", flush=True)
    print(f"headline: back-to-back step {h['step_ms']:.4f} ms on the host clock "
          f"(device idle share {max(0.0, 1 - t.median_ms / h['step_ms']):.4f}); "
          f"with rand_participants=1 {h['rp1_ms']:.4f} ms", flush=True)

    c3 = phase_config3(mhz)
    t3 = c3["timing"]
    total3 = CONFIG3["n_chunks"] * CONFIG3["p_chunk"]
    print(f"config 3: {c3['shape']} on {card}: one B2 call (memset, mxu8_split_kernel, "
          f"mxu8_epilogue_kernel), median {t3.median_ms:.4f} ms "
          f"(min {t3.min_ms:.4f}, max {t3.max_ms:.4f}, {len(t3.samples_ms)} steps), "
          f"{total3 / (t3.median_ms / 1e3):.0f} aggregations/s; bound {c3['bound_ms']:.4f} ms "
          f"({c3['bound_by']}; Philox issue {c3['parts']['philox']:.4f} at "
          f"{c3['philox_call_ops']} per call); plain on card {c3['plain_ms']:.1f} ms; reveal exact",
          flush=True)
    td = c3["device_timing"]
    print(f"config 3: the card's time for a step (windows queued behind a spin) median "
          f"{td.median_ms:.4f} ms (min {td.min_ms:.4f}, max {td.max_ms:.4f}), "
          f"{c3['bound_ms'] / td.median_ms:.4f} of the bound", flush=True)
    print(f"config 3: S={c3['splits']} splits x {c3['lane_blocks']} lane blocks = "
          f"{c3['grid_blocks']} split blocks; split kernel: {_launch_text(c3['launch'])}; "
          f"epilogue kernel ({c3['lane_blocks']} blocks): {_launch_text(c3['epilogue_launch'])}",
          flush=True)
    ph = c3["phase_ms"]
    print(f"config 3: phases: {_by_kernel_text(c3['by_kernel_ms'])} (torch.profiler); at S="
          f"{c3['splits']}, whole calls of cut plans (events): "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in ph.items())
          + "; the whole call at S = "
          + ", ".join(f"{sp}: {ms:.4f} ms" for sp, ms in c3["sweep_ms"].items()), flush=True)

    c4 = phase_config4(mhz)
    s4 = c4["step"]
    total4 = CONFIG4["n_chunks"] * CONFIG4["p_chunk"]
    print(f"config 4: {c4['shape']} on {card}: B1 x {c4['fused_launches']} + B3 x "
          f"{c4['launches']}, step median {s4.median_ms:.4f} ms (min {s4.min_ms:.4f}, "
          f"max {s4.max_ms:.4f}, {len(s4.samples_ms)} steps, events), "
          f"{total4 / (s4.median_ms / 1e3):.0f} aggregations/s; step bound "
          f"{c4['step_bound_ms']:.4f} ms ({c4['step_bound_by']}, {c4['step_bytes'] / 1e9:.2f} GB); "
          f"reveal exact", flush=True)
    print(f"config 4: B3 launch median {c4['timing'].median_ms:.4f} ms (min "
          f"{c4['timing'].min_ms:.4f}, max {c4['timing'].max_ms:.4f}), bound "
          f"{c4['bound_ms']:.4f} ms ({c4['bound_by']}; Philox issue {c4['parts']['philox']:.4f} at "
          f"{c4['philox_call_ops']} per call; {_launch_text(c4['launch'])}), plain on card "
          f"{c4['plain_ms']:.1f} ms; "
          f"first chunk (B1) {c4['first_ms']:.4f} ms, reconstruction {c4['rec_ms']:.4f} ms; "
          f"back-to-back step {c4['host_step_ms']:.4f} ms on the host clock, kernels "
          f"{c4['kernel_sum_ms']:.4f} ms, device idle share {c4['idle_share']:.4f}", flush=True)
    print(f"config 4: torch.profiler trace of two steps (profile_calls), per step: device busy "
          f"{c4['traced_busy_ms']:.4f} ms of {c4['traced_wall_ms']:.4f} ms on the host clock "
          f"({c4['traced_activities']} device activities), device idle share "
          f"{c4['traced_idle_share']:.4f}", flush=True)

    wd = phase_wide()
    for line in _wide_lines(wd, card):
        print(line, flush=True)

    sv = phase_serving(mhz)
    for combined in (False, True):
        r = sv[combined]
        ts = r["timing"]
        print(f"serving: {sv['shape']} combined_randomness={combined} on {card}: one launch, "
              f"median {ts.median_ms:.4f} ms (min {ts.min_ms:.4f}, max {ts.max_ms:.4f}), "
              f"{SERVING['jobs'] / (ts.median_ms / 1e3):.0f} jobs/s; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; Philox issue {r['parts']['philox']:.4f}); jobs 0, 1, "
              f"{SERVING['jobs'] - 1} revealed exactly", flush=True)

    fwd_s = phase_forward()
    print(f"forward: CIOS forward, 32 x {HEADLINE_DIM}, revealed exactly in {fwd_s:.3f} s", flush=True)

    cc = phase_compare_chacha()
    m4, m5 = cc["mid4"], cc["mid5"]
    print(f"chacha compare: B4 {cc['cases']['chacha_keystream']} cases, expand_masks_device "
          f"{cc['cases']['expand']} (4 moduli), B5 {cc['cases']['chacha_fold']} bit-equal to the "
          f"plain versions; 16,500 seeds: 2 B5 launches, equal to the host oracle; 2^62 + 1: "
          f"{cc['forced_bad']} bad seeds, exact after the fix-up; lowered zone: "
          f"{cc['zone_hits']} hits counted bit-equal, fused-route fix-up of 600 seeds exact",
          flush=True)
    print(f"chacha compare: mid shape on {card}: B4 {m4['shape']} kernel "
          f"{m4['kernel'].median_ms:.4f} ms, plain on card {m4['plain'].median_ms:.4f} ms; B5 "
          f"{m5['shape']} kernel {m5['kernel'].median_ms:.4f} ms, plain on card "
          f"{m5['plain'].median_ms:.4f} ms, plain (CPU) {m5['plain_cpu_ms']:.1f} ms", flush=True)

    cr = phase_chacha_reveal(mhz)
    tr = cr["timing"]
    hm = cr["host_ms"]
    print(f"chacha reveal: {cr['shape']} on {card}: one B5 launch per combine, median "
          f"{tr.median_ms:.4f} ms (min {tr.min_ms:.4f}, max {tr.max_ms:.4f}, "
          f"{len(tr.samples_ms)} launches, events); bound {cr['bound_ms']:.4f} ms "
          f"({cr['bound_by']}: {cr['ops']:.4g} INT32 ops at {SMS} x {ISSUE_LANES} lanes x "
          f"{mhz:.0f} MHz; the {INT32_LANES} INT32 lanes alone {cr['int32_only_ms']:.4f} ms; "
          f"bytes {cr['bytes'] / PEAK_BYTES * 1e3:.4f} ms)", flush=True)
    print(f"chacha reveal: ChaChaMasker.combine on the host clock median {hm[1]:.4f} ms (min "
          f"{hm[0]:.4f}, max {hm[2]:.4f}; first {cr['first_host_ms']:.4f}), "
          f"{CHACHA['seeds'] / (hm[1] / 1e3):.0f} seeds/s; bad seeds {cr['bad']}; dimensions "
          f"[0, {CHACHA['window']}), the last {CHACHA['tail']} and {cr['checked']} in all exact",
          flush=True)

    fr = phase_fused_recombine()
    for line in _fused_recombine_lines(fr, card):
        print(line, flush=True)

    ch = phase_chunk_route(mhz)
    tc = ch["timing"]
    print(f"chunk route: {CHACHA['chunk_seeds']} seeds x {CHACHA['dimension']} on {card}: B4 x "
          f"{ch['launches']}, combine_masks_device {ch['host_ms']:.4f} ms on the host clock, "
          f"windows exact, bad seeds {ch['bad']}; B4 {ch['shape']} median "
          f"{tc.median_ms:.4f} ms (min {tc.min_ms:.4f}, max {tc.max_ms:.4f}), bound "
          f"{ch['bound_ms']:.4f} ms ({ch['bound_by']}; the {INT32_LANES} INT32 lanes alone "
          f"{ch['int32_only_ms']:.4f} ms; bytes {ch['bytes'] / PEAK_BYTES * 1e3:.4f} ms)",
          flush=True)

    fm = phase_fullmask()
    print(f"full-mask reveal: {fm['shape']} on {card}: FullMasker.combine on the card "
          f"{fm['device_ms']:.4f} ms on the host clock, equal to the host fold "
          f"({fm['host_ms']:.4f} ms)", flush=True)

    cases7, err7, mid7 = phase_compare_mxu7()
    ring7, ring7_err = phase_compare_ring7()
    err7 = max(err7, ring7_err)
    print(f"mxu7 compare: {cases7} kernel/plain cases bit-equal at the mid shape "
          f"({mid7['shape']}; caller randomness, rand-sum P=16, grouped P=131; combined, out7, "
          f"fused reconstruction; reconstruct-only) at 4 moduli; ring cases ({len(RING7_CASES)} "
          f"shapes: K below one tile, below the ring, not a multiple of 64; NBP past the last "
          f"block; 4-byte and byte copies; 128-bit; p433; each in caller-randomness, rand-sum "
          f"and grouped (P={P_GROUPED}) mode, combined, out7 and reconstructed, and "
          f"reconstruct-only): {ring7} cases bit-equal; share_mxu == CIOS share and the "
          f"aggregate_mxu reveal exact on the card; kernel {mid7['kernel_ms']:.4f} ms, "
          f"plain (CPU) {mid7['plain_cpu_ms']:.1f} ms", flush=True)
    g3 = phase_gen3_headline(mhz)
    t6 = g3["timing"]
    pp = g3["parts"]
    print(f"gen-3 headline: {g3['shape']} on {card}: one B6 launch, median {t6.median_ms:.4f} ms "
          f"(min {t6.min_ms:.4f}, max {t6.max_ms:.4f}, {len(t6.samples_ms)} steps), "
          f"{HEADLINE_P / (t6.median_ms / 1e3):.0f} aggregations/s; bound {g3['bound_ms']:.4f} ms "
          f"({g3['bound_by']}: bytes {pp['bytes']:.4f}, int8 {pp['int8']:.4f}, Philox issue "
          f"{pp['philox']:.4f} at {g3['philox_call_ops']} SASS instructions per call); plain on "
          f"card {g3['plain_ms']:.1f} ms; reveal exact; {_launch_text(g3['launch'])}", flush=True)
    te = g3["ext_timing"]
    print(f"gen-3 headline: back-to-back step {g3['step_ms']:.4f} ms on the host clock (device "
          f"idle share {max(0.0, 1 - t6.median_ms / g3['step_ms']):.4f}); caller randomness "
          f"{g3['ext_shape']}: one launch, median {te.median_ms:.4f} ms (min {te.min_ms:.4f}, "
          f"max {te.max_ms:.4f}), bound {g3['ext_bound_ms']:.4f} ms ({g3['ext_bound_by']}), "
          f"reveal exact; {_launch_text(g3['ext_launch'])}", flush=True)
    sp = g3["split_ms"]
    print(f"gen-3 headline: phases of the B6 launch: K loop alone {sp['loop']:.4f} ms, "
          f"randomness passes behind a one-tile K loop {sp['randomness']:.4f} ms, neither (one "
          f"tile and the epilogue) {sp['neither']:.4f} ms", flush=True)
    s3 = phase_gen3_streaming(mhz)
    ts3 = s3["step"]
    total3s = CONFIG4["n_chunks"] * CONFIG4["p_chunk"]
    print(f"gen-3 streaming: {s3['shape']} on {card}: B6 x {s3['launches']}, step median "
          f"{ts3.median_ms:.4f} ms (min {ts3.min_ms:.4f}, max {ts3.max_ms:.4f}, "
          f"{len(ts3.samples_ms)} steps, events), {total3s / (ts3.median_ms / 1e3):.0f} "
          f"aggregations/s; step bound {s3['step_bound_ms']:.4f} ms; chunk launch "
          f"{s3['chunk_timing'].median_ms:.4f} ms; back-to-back step {s3['host_step_ms']:.4f} ms "
          f"on the host clock (device idle share {s3['idle_share']:.4f}); reveal exact; "
          f"chunk: {_launch_text(s3['launch'])}; reconstruction: "
          f"{_launch_text(s3['rec_launch'])}", flush=True)
    casesp, errp, midp = phase_compare_planar()
    print(f"planar compare: {casesp} kernel/plain cases bit-equal at the mid shape "
          f"({midp['shape']}; PRNG and caller randomness at p433, additive 2^61-1, p62, "
          f"2^127-1495), reveals exact; kernel {midp['kernel_ms']:.4f} ms, plain (CPU) "
          f"{midp['plain_cpu_ms']:.1f} ms", flush=True)
    g1 = phase_gen1_headline(mhz)
    t7 = g1["timing"]
    p1 = g1["parts"]
    print(f"gen-1 headline: {g1['shape']} on {card}: one B7 launch per step, launch median "
          f"{t7.median_ms:.4f} ms (min {t7.min_ms:.4f}, max {t7.max_ms:.4f}), step "
          f"(B7 + planar copy + CIOS reconstruct) {g1['step'].median_ms:.4f} ms; bound "
          f"{g1['bound_ms']:.4f} ms ({g1['bound_by']}: issue {p1['issue']:.4f} for "
          f"{g1['ops']['total']} SASS instructions per lane and participant, "
          f"{g1['ops']['total'] * g1['work']:.4g} in all; bytes {p1['bytes']:.4f}); of them "
          f"{g1['ops']['fma']} on the FMA pipe ({g1['pipes']['fma']:.4f} ms at "
          f"{INT32_LANES} lanes), {g1['ops']['alu']} on the INT32 pipe "
          f"({g1['pipes']['alu']:.4f} ms at {INT32_LANES} lanes); plain on card "
          f"{g1['plain_ms']:.1f} ms ({g1['plain_shape']}); reveal exact", flush=True)
    print(f"gen-1 streaming: {GEN1_STREAM['chunks']} chunks x {GEN1_STREAM['p_chunk']} "
          f"participants x {HEADLINE_DIM}, caller randomness: B7 x {g1['stream_launches']}, "
          f"equal to the one-shot aggregate_fused_ext, reveal exact", flush=True)

    pc = phase_probe_compare()
    for probe, r in pc.items():
        tp = r["timing"]
        print(f"probe compare: {probe} ({r['shape']}) on {card}: output seed-filled and bit-equal "
              f"to the plain version, sinks bit-equal, sink XOR == torch's XOR of the input; "
              f"median {tp.median_ms:.4f} ms (min {tp.min_ms:.4f}, max {tp.max_ms:.4f}), "
              f"{r['bytes'] / (tp.median_ms / 1e3) / 1e12:.3f} TB/s; bound {r['bound_ms']:.4f} ms "
              f"(bytes); plain on card {r['plain_ms']:.4f} ms; library {r['library_ms']:.4f} ms "
              f"({r['bytes'] / (r['library_ms'] / 1e3) / 1e12:.3f} TB/s)", flush=True)

    tools = phase_tools()
    lat, lane, sweep = (tools[k]["artifact"] for k in ("latency", "lane_batch", "config3"))
    print(f"tool latency floor: config-2 job {lat['single_job_s'] * 1e3:.4f} ms on {card}, T1 "
          f"copy floor {lat['noop_same_shape_s'] * 1e3:.4f} ms (bound "
          f"{lat['noop_bound_s'] * 1e3:.4f}), T1' bare launch {lat['bare_launch_s'] * 1e3:.4f} ms, "
          f"kernel work {lat['kernel_work_s'] * 1e3:.4f} ms, {lat['fraction_of_sol']:.4f} of the "
          f"job's bound; {lat['batched_jobs']} jobs in one launch "
          f"{lat['batched64_per_job_s'] * 1e3:.4f} ms per job; reveals exact; "
          f"probe_t1 x {tools['latency']['counts']['probe_t1']}, probe_t1_bare x "
          f"{tools['latency']['counts']['probe_t1_bare']}; {tools['latency']['s']:.1f} s; "
          f"wrote {tools['latency']['path'].relative_to(root)}", flush=True)
    ex, dec = lane["experiments"], lane["decomposition"]
    real_lane = ex[f"real_lanes{lane['shape']['kernel_lanes']}"]["s"]["median"]
    print(f"tool lane-batch floor: 512 jobs on {card}: real {real_lane * 1e3:.4f} ms, "
          f"T2 copy floor {dec['dma_floor_s'] * 1e3:.4f} ms ({dec['copy_floor_tb_s']:.3f} TB/s; "
          f"library {dec['library_tb_s']:.3f} TB/s), combine only "
          f"{ex['combine_only']['s']['median'] * 1e3:.4f} ms, caller randomness "
          f"{ex['host_randomness']['s']['median'] * 1e3:.4f} ms, combined draw "
          f"{ex['combined_draw']['s']['median'] * 1e3:.4f} ms, 4x participants "
          f"{ex['same_bytes_4x_participants']['s']['median'] * 1e3:.4f} ms; reveals exact; "
          f"probe_t2 x {tools['lane_batch']['counts']['probe_t2']}; "
          f"{tools['lane_batch']['s']:.1f} s; "
          f"wrote {tools['lane_batch']['path'].relative_to(root)}", flush=True)
    best, ctl, bc = sweep["best"], sweep["controls_at_best"], sweep["noop_at_best_chunked"]
    print(f"tool config-3 sweep: {len(sweep['rows'])} launches on {card}, best n_chunks="
          f"{best['n_chunks']} NBP={best['nbp']} S={best['splits']} ({best['grid_blocks']} "
          f"blocks) {best['ms']:.4f} ms "
          f"({best['fraction_of_sol']:.4f} of its bound); best of more than one chunk "
          f"n_chunks={bc['n_chunks']} NBP={bc['nbp']} S={bc['splits']} ({bc['grid_blocks']} "
          f"blocks) {bc['real_ms']:.4f} ms, its T3 copy floor "
          f"{bc['noop_ms']:.4f} ms ({bc['copy_floor_tb_s']:.3f} TB/s); at the best, T3 copy floor "
          f"{ctl['noop_dma_floor_ms']:.4f} ms "
          f"({ctl['copy_floor_tb_s']:.3f} TB/s; library {ctl['library_tb_s']:.3f} TB/s), combined "
          f"draw {ctl['combined_draw_ms']:.4f} ms, no reconstruction "
          f"{ctl['no_reconstruction_ms']:.4f} ms; reveals exact; probe_t3 x "
          f"{tools['config3']['counts']['probe_t3']}; {tools['config3']['s']:.1f} s; "
          f"wrote {tools['config3']['path'].relative_to(root)}", flush=True)

    from sda_tpu_torch.parallel import make_mesh

    ms = phase_mesh(make_mesh(MESH_AXES))
    torch.distributed.destroy_process_group()
    for line in _mesh_lines(ms, card):
        print(line, flush=True)
    ml = ms["launches"]
    dr = phase_drivers()
    for line in _drivers_lines(dr, card, c4["timing"].median_ms):
        print(line, flush=True)
    dl = dr["launches"]
    print(_crypto_line(phase_crypto(), card), flush=True)
    fl = phase_full_loop()
    for line in _loop_lines(fl, card):
        print(line, flush=True)
    tl = phase_tolerance()
    for line in _tolerance_lines(tl, card):
        print(line, flush=True)
    print(_cli_line(phase_cli(), card), flush=True)
    print(_crossover_line(phase_crossover(), card, root), flush=True)

    bd = phase_breakdown()
    for line in _breakdown_lines(bd, card):
        print(line, flush=True)
    rf = phase_roofline(h)
    for line in _roofline_lines(rf, h, card, root):
        print(line, flush=True)
    full, comb = rf["artifact"]["full_pipeline"], rf["artifact"]["combine_only"]
    print(_chacha_native_line(phase_chacha_native(), cr, card), flush=True)
    print(f"example: examples/bulk_aggregation_torch.py --device cuda at its defaults on {card} "
          f"(torch CIOS, no kernel launched): exit 0; " + " | ".join(phase_example()), flush=True)
    print(_scaling_line(*phase_scaling_artifact(dr, card, name), root), flush=True)

    print(card)
    print(json.dumps({"kernels": [
        {
            "name": "mxu8_fused",
            "route": "cuda",
            "source": "sda_tpu_torch/ops/csrc/mxu8.cu",
            "replaces": "sda_tpu/ops/mxu8.py:454",
            "launches": h["launches"],
            "max_abs_err": max(cmp_err, h["max_abs_err"], sv[False]["max_abs_err"],
                               sv[True]["max_abs_err"]),
            "ms": t.median_ms,
            "min_ms": t.min_ms,
            "max_ms": t.max_ms,
            "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"],
            "bound_parts_ms": h["parts"],
            "philox_call_sass": h["philox_call_ops"],
            "sm_mhz": mhz,
            **h["launch"],
            "library_ms": None,
            "shape": h["shape"],
            "step_ms": h["step_ms"],
            "rand_participants_1_ms": h["rp1_ms"],
            "mid_kernel_ms": mid["kernel_ms"],
            "mid_plain_cpu_ms": mid["plain_cpu_ms"],
            "mid_shape": mid["shape"],
            "launches_config4": c4["fused_launches"],
            "launches_serving": [sv[False]["launches"], sv[True]["launches"]],
            "serving_ms": [sv[False]["timing"].median_ms, sv[True]["timing"].median_ms],
            "serving_bound_ms": sv[False]["bound_ms"],
            "serving_shape": sv["shape"],
            "mesh_launches": {"step": ml["the mesh gen-4 step"]["mxu8_fused"],
                              "stream": ml["the mesh gen-4 stream"]["mxu8_fused"],
                              "lane_batch": ml["the mesh lane batch"]["mxu8_fused"],
                              "degraded_finish": ml["the degraded finish without clerk 0"]
                              ["mxu8_fused"]},
            "mesh_step_ms": ms["gen4"]["mesh"].median_ms,
            "mesh_engine_step_ms": ms["gen4"]["engine"].median_ms,
            "drivers_launches": {"dryrun": dl["the dryrun"]["mxu8_fused"],
                                 "config5_loop": dl["the config-5 chunk loop"]["mxu8_fused"],
                                 "config5_finish": dl["the config-5 finish"]["mxu8_fused"],
                                 "weak_step": dl["the weak-scaling step"]["mxu8_fused"]},
            "config5_finish_ms": dr["config5"]["finish"].median_ms,
            "weak_step_ms": dr["weak"]["step"].median_ms,
            "breakdown_launches": {label: b["launches"] for label, b in bd.items()},
            "breakdown_ms": {label: b["by_kernel_ms"]["mxu8_fused_kernel"]
                             for label, b in bd.items()},
            "roofline_launches": rf["launches"],
            "roofline_full_ms": full["seconds"] * 1e3,
            "roofline_combine_only_ms": comb["seconds"] * 1e3,
        },
        {
            "name": "mxu8_wide",
            "route": "cuda",
            "source": "sda_tpu_torch/ops/csrc/mxu8.cu",
            "replaces": "sda_tpu/ops/mxu8.py:454",
            "launches": wd["prng"]["launches"],
            "max_abs_err": 0,
            "ms": wd["prng"]["b1"].median_ms,
            "min_ms": wd["prng"]["b1"].min_ms,
            "max_ms": wd["prng"]["b1"].max_ms,
            "bound_ms": wd["prng"]["bound"][0],
            "bound_by": wd["prng"]["bound"][1],
            "shape_bound_ms": wd["prng"]["shape_bound"][0],
            "library_ms": None,
            "shape": f"{wd['shape']} P={wd['prng']['P']} (PRNG)",
            "b3_ms": wd["prng"]["b3"].median_ms,
            "caller_ms": wd["caller"]["b1"].median_ms,
            "caller_b3_ms": wd["caller"]["b3"].median_ms,
            "caller_shape": f"P={wd['caller']['P']} (caller randomness)",
            "caller_bound_ms": wd["caller"]["bound"][0],
            "reconstruct_ms": wd["rec"]["kernel"].median_ms,
            "reconstruct_bound_ms": wd["rec"]["bound"][0],
            "subset_plan_ms": wd["rec"]["plan_ms"],
        },
        {
            "name": "mxu8_chunked",
            "route": "cuda",
            "source": "sda_tpu_torch/ops/csrc/mxu8.cu",
            "replaces": "sda_tpu/ops/mxu8.py:496",
            "launches": c3["launches"],
            "max_abs_err": max(cmp_err2["mxu8_chunked"], c3["max_abs_err"]),
            "ms": t3.median_ms,
            "min_ms": t3.min_ms,
            "max_ms": t3.max_ms,
            "plain_ms": c3["plain_ms"],
            "bound_ms": c3["bound_ms"],
            "bound_by": c3["bound_by"],
            "bound_parts_ms": c3["parts"],
            "philox_call_sass": c3["philox_call_ops"],
            **c3["launch"],
            "library_ms": None,
            "shape": c3["shape"],
            "device_ms": c3["device_timing"].median_ms,
            "splits": c3["splits"],
            "grid_blocks": c3["grid_blocks"],
            "kernels": ["mxu8_split_kernel", "mxu8_epilogue_kernel"],
            "epilogue_launch": c3["epilogue_launch"],
            "by_kernel_ms": _b2_kernels(c3["by_kernel_ms"]),
            "phase_ms": c3["phase_ms"],
            "splits_sweep_ms": {str(k): v for k, v in c3["sweep_ms"].items()},
        },
        {
            "name": "mxu8_acc",
            "route": "cuda",
            "source": "sda_tpu_torch/ops/csrc/mxu8.cu",
            "replaces": "sda_tpu/ops/mxu8.py:474",
            "launches": c4["launches"],
            "max_abs_err": max(cmp_err2["mxu8_acc"], c4["max_abs_err"]),
            "ms": c4["timing"].median_ms,
            "min_ms": c4["timing"].min_ms,
            "max_ms": c4["timing"].max_ms,
            "plain_ms": c4["plain_ms"],
            "bound_ms": c4["bound_ms"],
            "bound_by": c4["bound_by"],
            "bound_parts_ms": c4["parts"],
            "philox_call_sass": c4["philox_call_ops"],
            **c4["launch"],
            "library_ms": None,
            "shape": c4["shape"],
            "config4_step_ms": s4.median_ms,
            "config4_step_bound_ms": c4["step_bound_ms"],
            "config4_host_step_ms": c4["host_step_ms"],
            "config4_idle_share": c4["idle_share"],
            "config4_traced_idle_share": c4["traced_idle_share"],
            "mesh_launches": ml["the mesh gen-4 stream"]["mxu8_acc"],
            "mesh_stream_ms": ms["gen4_stream"]["mesh"].median_ms,
            "mesh_engine_stream_ms": ms["gen4_stream"]["engine"].median_ms,
            "drivers_launches": {"dryrun": dl["the dryrun"]["mxu8_acc"],
                                 "config5_loop": dl["the config-5 chunk loop"]["mxu8_acc"]},
            "config5_loop_ms": dr["config5"]["loop"].median_ms,
            "config5_loop_bound_ms": dr["config5"]["loop_bound"][0],
        },
        {
            "name": "chacha_keystream",
            "route": "cuda",
            "source": "sda_tpu_torch/ops/csrc/chacha.cu",
            "replaces": "sda_tpu/ops/chacha_kernel.py:59",
            "launches": ch["launches"],
            "max_abs_err": cc["max_err"]["chacha_keystream"],
            "ms": tc.median_ms,
            "min_ms": tc.min_ms,
            "max_ms": tc.max_ms,
            "plain_ms": m4["plain"].median_ms,
            "plain_shape": f"{m4['shape']} (mid shape, plain version on the card)",
            "mid_ms": m4["kernel"].median_ms,
            "bound_ms": ch["bound_ms"],
            "bound_by": ch["bound_by"],
            "int32_lanes_only_ms": ch["int32_only_ms"],
            "sm_mhz": mhz,
            "library_ms": None,
            "shape": ch["shape"],
            "chunk_route_host_ms": ch["host_ms"],
            "tolerance_launches": tl["launches"].get("chacha_keystream", 0),
            "tolerance_shape": f"S={TOLERANCE['participants']} d={TOLERANCE['dimension']}",
            "tolerance_route_ms": tl["chunk_route"].median_ms,
        },
        {
            "name": "chacha_fold",
            "route": "cuda",
            "source": "sda_tpu_torch/ops/csrc/chacha.cu",
            "replaces": "sda_tpu/ops/chacha_kernel.py:199",
            "launches": cr["launches"],
            "max_abs_err": cc["max_err"]["chacha_fold"],
            "ms": tr.median_ms,
            "min_ms": tr.min_ms,
            "max_ms": tr.max_ms,
            "plain_ms": m5["plain"].median_ms,
            "plain_shape": f"{m5['shape']} (mid shape, plain version on the card)",
            "mid_ms": m5["kernel"].median_ms,
            "bound_ms": cr["bound_ms"],
            "bound_by": cr["bound_by"],
            "int32_lanes_only_ms": cr["int32_only_ms"],
            "sm_mhz": mhz,
            "library_ms": None,
            "shape": cr["shape"],
            "combine_host_ms": hm[1],
            "seeds_per_s": CHACHA["seeds"] / (hm[1] / 1e3),
            "fullmask_device_ms": fm["device_ms"],
            "loop_launches": fl["A"]["launches"]["chacha_fold"],
            "loop_shape": f"S={FULL_LOOP['A']['participants']} d={FULL_LOOP['A']['dimension']}",
            "loop_ms": fl["b5"].median_ms,
            "loop_reveal_host_ms": fl["A"]["s"]["reveal"] * 1e3,
            "tolerance_launches": tl["launches"].get("chacha_fold", 0),
            "tolerance_route_ms": tl["fused_route"].median_ms,
        },
        {
            "name": "mxu7_fused",
            "route": "cuda",
            "source": "sda_tpu_torch/ops/csrc/mxu7.cu",
            "replaces": "sda_tpu/ops/mxu_kernel.py:261",
            "launches": g3["launches"],
            "max_abs_err": max(err7, g3["max_abs_err"]),
            "ms": t6.median_ms,
            "min_ms": t6.min_ms,
            "max_ms": t6.max_ms,
            "plain_ms": g3["plain_ms"],
            "bound_ms": g3["bound_ms"],
            "bound_by": g3["bound_by"],
            "bound_parts_ms": g3["parts"],
            "philox_call_sass": g3["philox_call_ops"],
            "sm_mhz": mhz,
            "library_ms": None,
            "shape": g3["shape"],
            "step_ms": g3["step_ms"],
            "ext_ms": te.median_ms, "phase_ms": g3["split_ms"],
            "ext_shape": g3["ext_shape"],
            "mid_kernel_ms": mid7["kernel_ms"],
            "mid_plain_cpu_ms": mid7["plain_cpu_ms"],
            "launches_streaming": s3["launches"],
            "streaming_step_ms": ts3.median_ms,
            "streaming_host_step_ms": s3["host_step_ms"],
            "streaming_step_bound_ms": s3["step_bound_ms"],
            "mesh_launches": {"step": ml["the mesh gen-3 step"]["mxu7_fused"],
                              "stream": ml["the mesh gen-3 stream"]["mxu7_fused"]},
            "mesh_step_ms": ms["gen3"]["mesh"].median_ms,
            "mesh_engine_step_ms": ms["gen3"]["engine"].median_ms,
            "drivers_launches": {"dryrun": dl["the dryrun"]["mxu7_fused"]},
        },
        {
            "name": "planar_cios",
            "route": "cuda",
            "source": "sda_tpu_torch/ops/csrc/planar_cios.cu",
            "replaces": "sda_tpu/ops/pallas_kernels.py:83",
            "launches": g1["launches"],
            "max_abs_err": max(errp, g1["max_abs_err"]),
            "ms": t7.median_ms,
            "min_ms": t7.min_ms,
            "max_ms": t7.max_ms,
            "plain_ms": g1["plain_ms"],
            "plain_shape": g1["plain_shape"],
            "bound_ms": g1["bound_ms"],
            "bound_by": g1["bound_by"],
            "bound_parts_ms": g1["parts"],
            "sass_per_lane_participant": g1["ops"],
            "pipe_ms": g1["pipes"],
            "sm_mhz": mhz,
            "library_ms": None,
            "shape": g1["shape"],
            "step_ms": g1["step"].median_ms,
            "mid_kernel_ms": midp["kernel_ms"],
            "mid_plain_cpu_ms": midp["plain_cpu_ms"],
            "launches_streaming": g1["stream_launches"],
        },
        *({
            "name": name,
            "route": "cuda",
            "source": "sda_tpu_torch/ops/csrc/probes.cu",
            "replaces": replaces,
            "launches": tools[tool]["counts"][name],
            "max_abs_err": max(pc[p]["max_abs_err"] for p in probes),
            "ms": pc[probes[0]]["timing"].median_ms,
            "min_ms": pc[probes[0]]["timing"].min_ms,
            "max_ms": pc[probes[0]]["timing"].max_ms,
            "plain_ms": pc[probes[0]]["plain_ms"],
            "bound_ms": pc[probes[0]]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": pc[probes[0]]["library_ms"],
            "shape": pc[probes[0]]["shape"],
            **extra,
        } for name, tool, replaces, probes, extra in (
            ("probe_t1", "latency", "tools/measure_latency_floor.py:76", ("T1", "T1'"), {
                "bare_replaces": "tools/measure_latency_floor.py:93",
                "bare_launches": tools["latency"]["counts"]["probe_t1_bare"],
                "bare_ms": pc["T1'"]["timing"].median_ms,
                "bare_bound_ms": pc["T1'"]["bound_ms"],
                "bare_library_ms": pc["T1'"]["library_ms"],
                "tool_noop_ms": lat["noop_same_shape_s"] * 1e3,
                "tool_bare_ms": lat["bare_launch_s"] * 1e3,
            }),
            ("probe_t2", "lane_batch", "tools/measure_lane_batch_floor.py:100", ("T2",), {
                "tool_noop_ms": lane["decomposition"]["dma_floor_s"] * 1e3,
            }),
            ("probe_t3", "config3", "tools/measure_config3_variants.py:126", ("T3",), {
                "tool_noop_ms": sweep["controls_at_best"]["noop_dma_floor_ms"],
                "tool_shape": f"n_chunks={sweep['best']['n_chunks']} NBP={sweep['best']['nbp']} "
                              f"S={sweep['best']['splits']}",
                "tool_chunked_noop_ms": bc["noop_ms"],
                "tool_chunked_shape": f"n_chunks={bc['n_chunks']} NBP={bc['nbp']} "
                                      f"S={bc['splits']}",
                "splits": pc["T3"]["splits"],
            }),
        )),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
