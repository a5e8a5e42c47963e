"""Where a run sits on its host: the card's bus id and NUMA node, the cores
local to it, the nodes of the cores the run keeps to, and the card's clocks,
power and temperature as ``nvidia-smi`` reads them. Only reads: nothing
here writes under ``/sys`` or sets anything of the card."""

from __future__ import annotations

import subprocess
from pathlib import Path

SYSFS = Path("/sys")
CLOCKS = "clocks.sm,clocks.mem,power.draw,temperature.gpu,clocks_throttle_reasons.active"


def smi(fields: str) -> str:
    """``nvidia-smi``'s reading of ``fields`` for the first card, or why
    there is none."""
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read: {exc!r}"


def parse_cpulist(text: str) -> list[int]:
    """The cores of a sysfs cpu list such as ``0-3,8,10-11``."""
    cores: list[int] = []
    for part in text.strip().split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        cores.extend(range(int(lo), int(hi or lo) + 1))
    return sorted(cores)


def _read(path: Path) -> str | None:
    try:
        return path.read_text()
    except OSError:
        return None


def card_node(bus_id: str, sysfs: Path = SYSFS) -> tuple[int | None, list[int]]:
    """The NUMA node of the card at ``bus_id`` (as ``nvidia-smi`` writes it,
    ``00000000:18:00.0``) and the cores local to it; ``None`` and ``[]``
    where sysfs does not say."""
    parts = bus_id.strip().lower().split(":")
    if len(parts) not in (2, 3):  # nvidia-smi may read "[N/A]"
        return None, []
    domain = parts[0][-4:] if len(parts) == 3 else "0000"
    # sysfs names the device by a four-digit domain: 0000:18:00.0
    dev = sysfs / "bus" / "pci" / "devices" / f"{domain:0>4}:{parts[-2]}:{parts[-1]}"
    node = _read(dev / "numa_node")
    local = _read(dev / "local_cpulist")
    number = int(node) if node is not None and node.strip().lstrip("-").isdigit() else None
    return (number if number is not None and number >= 0 else None,
            parse_cpulist(local) if local else [])


def core_nodes(cores, sysfs: Path = SYSFS) -> list[int]:
    """The NUMA nodes that hold ``cores``."""
    nodes = set()
    for path in sorted((sysfs / "devices" / "system" / "node").glob("node[0-9]*")):
        listed = _read(path / "cpulist")
        if listed and set(parse_cpulist(listed)) & set(cores):
            nodes.add(int(path.name[4:]))
    return sorted(nodes)
