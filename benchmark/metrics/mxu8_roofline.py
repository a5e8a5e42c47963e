"""The aggregation's byte bound (participant elements at the field's byte
width and the revealed vector once, over the HBM rate) over the device time
of the round's ``mxu8_*`` kernels in the trace, in percent."""

from benchmark.core import yardstick


def read(record):
    t = record.trace
    if t is None or not t.rounds:
        return None
    seconds = t.kernel_seconds("mxu8") / t.rounds
    if seconds <= 0:
        return None
    cfg, traffic = record.cell.config, record.cell.traffic
    bound = yardstick.aggregate_bound_s(int(traffic["participants"]), int(cfg["dimension"]),
                                        int(cfg["field_bits"]))
    return 100.0 * bound / seconds
