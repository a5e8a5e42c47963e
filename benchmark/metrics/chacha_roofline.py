"""The mask expansion's operation bound (ChaCha20's own operations for every
seed's draws and the fold's adds, over the SMs' 32-bit issue rate at the
boost clock) over the device time of the round's ``chacha*`` kernels in the
trace, in percent."""

from benchmark.core import yardstick


def read(record):
    t = record.trace
    if t is None or not t.rounds or not record.cell.masking:
        return None
    seconds = t.kernel_seconds("chacha") / t.rounds
    if seconds <= 0:
        return None
    cfg, traffic = record.cell.config, record.cell.traffic
    bound = yardstick.chacha_bound_s(int(traffic["participants"]), int(cfg["dimension"]))
    return 100.0 * bound / seconds
