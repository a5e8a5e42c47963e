"""The yardstick's bounds come from the configurations' shapes and the fixed
card table, with no kernel built and nothing of the program loaded."""

import json
import subprocess
import sys

from benchmark.core import spec, yardstick


def test_counts_from_shapes():
    assert yardstick.field_bytes(63) == 8 and yardstick.field_bytes(127) == 16
    assert yardstick.chacha_blocks(1_000_002) == 125_001
    assert yardstick.chacha_ops(10_752, 1_000_002) == 10_752 * 125_001 * 992
    assert abs(yardstick.chacha_bound_s(10_752, 1_000_002) * 1e3 - 39.853) < 0.001
    assert abs(yardstick.aggregate_bound_s(10_752, 1_000_002, 63) * 1e3 - 25.68) < 0.01
    assert abs(yardstick.aggregate_bound_s(768, 1_000_002, 63) * 1e3 - 1.836) < 0.001
    assert abs(yardstick.aggregate_bound_s(1_024, 10_002, 127) * 1e3 - 0.04896) < 1e-5


def test_the_bounds_need_no_build_and_no_program():
    """In a process where the program cannot be imported, the readers of the
    rooflines give the same bounds: nothing is read from built code."""
    code = (
        "import sys; sys.modules['sda_tpu_torch'] = None\n"
        f"sys.path.insert(0, {str(spec.ROOT)!r})\n"
        "from benchmark.core import yardstick\n"
        "print(yardstick.aggregate_bound_s(10752, 1000002, 63),"
        " yardstick.chacha_bound_s(10752, 1000002))\n"
        "assert not [m for m in sys.modules if m.startswith('sda_tpu_torch.')]\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.split()
    assert [float(v) for v in out] == [yardstick.aggregate_bound_s(10752, 1000002, 63),
                                       yardstick.chacha_bound_s(10752, 1000002)]


def test_card_table_is_the_h100_sxm_data_sheet():
    assert yardstick.CARD == {"name": "NVIDIA H100 SXM", "hbm_bytes_per_s": 3.35e12, "sms": 132,
                              "issue_lanes": 128, "sm_mhz": 1980.0}
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    assert all(m["unit"] == "%" for m in bench["per_layer"] if m["name"].endswith("_roofline"))
