"""Where a run sits on its host, read from a fake sysfs tree: the card's
node and local cores, and the nodes of the run's cores."""

import pytest

from benchmark.core import host


def _sysfs(tmp_path, numa="1", local="8-11,24-27", nodes=("0-7,16-23", "8-15,24-31")):
    dev = tmp_path / "bus" / "pci" / "devices" / "0000:18:00.0"
    dev.mkdir(parents=True)
    if numa is not None:
        (dev / "numa_node").write_text(numa + "\n")
    if local is not None:
        (dev / "local_cpulist").write_text(local + "\n")
    for i, cpus in enumerate(nodes):
        node = tmp_path / "devices" / "system" / "node" / f"node{i}"
        node.mkdir(parents=True)
        (node / "cpulist").write_text(cpus + "\n")
    return tmp_path


@pytest.mark.parametrize("text,cores", [("0-3,8,10-11\n", [0, 1, 2, 3, 8, 10, 11]),
                                        ("5", [5]), ("", [])])
def test_cpu_lists(text, cores):
    assert host.parse_cpulist(text) == cores


def test_card_node_and_local_cores(tmp_path):
    sysfs = _sysfs(tmp_path)
    assert host.card_node("00000000:18:00.0", sysfs) == (1, [8, 9, 10, 11, 24, 25, 26, 27])
    assert host.card_node("0000:18:00.0", sysfs)[0] == 1
    assert host.core_nodes([6, 7], sysfs) == [0] and host.core_nodes([7, 8], sysfs) == [0, 1]


@pytest.mark.parametrize("numa,local", [("-1", ""), (None, None)])
def test_sysfs_that_says_nothing(tmp_path, numa, local):
    assert host.card_node("00000000:18:00.0", _sysfs(tmp_path, numa, local)) == (None, [])
    assert host.card_node("00000000:3b:00.0", tmp_path) == (None, [])
    assert host.card_node("[N/A]", tmp_path) == (None, [])
