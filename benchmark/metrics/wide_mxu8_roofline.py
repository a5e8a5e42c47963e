"""The sharing contraction's bound (:mod:`benchmark.core.share_yardstick`:
the larger of its int8 multiply-adds over the tensor rate and its bytes
over the HBM rate) over the device time of the round's ``mxu8*`` kernels
in the trace, in percent."""

from benchmark.core import share_yardstick


def read(record):
    t = record.trace
    if t is None or not t.rounds:
        return None
    seconds = t.kernel_seconds("mxu8") / t.rounds
    if seconds <= 0:
        return None
    cfg, traffic = record.cell.config, record.cell.traffic
    bound = share_yardstick.share_bound_s(
        int(traffic["participants"]), int(cfg["dimension"]), int(cfg["secret_count"]),
        int(cfg["share_count"]), int(cfg["field_bits"]))
    return 100.0 * bound / seconds
