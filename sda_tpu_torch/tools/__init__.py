"""The port's measurement tools, each runnable as ``python3 -m
sda_tpu_torch.tools.<name>`` and writing ``build/measurements/<NAME>.json``:

- :mod:`~sda_tpu_torch.tools.measure_latency_floor`: the config-2 single
  job against its copy floor (T1) and the bare launch floor (T1');
- :mod:`~sda_tpu_torch.tools.measure_lane_batch_floor`: the 512-job lane
  batch against its copy floor (T2) and its variants;
- :mod:`~sda_tpu_torch.tools.measure_config3_variants`: the config-3 launch
  sweep and its controls (T3);
- :mod:`~sda_tpu_torch.tools.measure_combine_crossover`: the clerk combine's
  fused native route against the streamed device route.

:mod:`~sda_tpu_torch.tools.bench_scaling` (the mesh's weak scaling and the
config-5 chunk-loop/finish split) prints its JSON and writes no artifact.
:mod:`~sda_tpu_torch.tools.bench_roofline` (the headline's full pipeline
and combine-only launches against the card's ceilings, with a per-kernel
breakdown) writes ``ROOFLINE.json``;
:mod:`~sda_tpu_torch.tools.make_scaling_artifact` (config 5's measured
split and a projection onto one NVLink node) writes ``SCALING.json``.

Each measuring function takes its shapes as arguments and a ``device``
(the card unless given ``"cpu"``); on the CPU it runs every check and
reports no time.
"""
