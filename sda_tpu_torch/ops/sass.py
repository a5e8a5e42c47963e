"""The SASS of the built kernels, and the loops the integer bounds count.

A kernel's least time on the integer pipes is counted from what was
compiled: ``cuobjdump -sass`` lists a built library (:func:`sass_listing`),
each kernel instantiation under a short label (:func:`kernel_label`), and
the Philox generator's loop is the innermost loop holding one of Philox's
multipliers (:func:`innermost_philox_loops`). ``cuobjdump`` runs only when
a listing is asked for, on a library already built.
"""

from __future__ import annotations

import functools
import re
import shutil
import subprocess

__all__ = [
    "kernel_label",
    "sass_listing",
    "parse_sass",
    "loops",
    "branch_target",
    "span",
    "innermost_philox_loops",
    "PHILOX_MUL_RE",
]

# Philox4x32-10's multipliers as cuobjdump prints an immediate (signed or not)
PHILOX_MUL_RE = re.compile(r"-0x2daee0ad|-0x326172a9|0xd2511f53|0xcd9e8d57", re.I)


def kernel_label(mangled: str):
    """Short name of a kernel instantiation: ``MT<n>`` for the mxu8 and
    mxu7 kernels' templates (B2: its split kernel), ``epi<n>`` for B2's
    epilogue kernel, ``L<n>`` for the planar CIOS kernel's, the function
    name for the ChaCha kernels."""
    m = re.search(r"mxu(?:[78]_fused|8_split)_kernelILi(\d+)E", mangled)
    if m:
        return f"MT{m.group(1)}"
    m = re.search(r"mxu8_epilogue_kernelILi(\d+)E", mangled)
    if m:
        return f"epi{m.group(1)}"
    m = re.search(r"planar_cios_kernelILi(\d+)E", mangled)
    if m:
        return f"L{m.group(1)}"
    m = re.search(r"probe_lanes_kernelILb([01])E", mangled)
    if m:
        return "T3" if m.group(1) == "1" else "T1/T2"
    if "probe_bare_kernel" in mangled:
        return "T1'"
    m = re.search(r"chacha_(?:keystream|fold)_kernel", mangled)
    return m.group(0) if m else None


@functools.lru_cache(maxsize=None)
def sass_listing(source: str, defines=()) -> dict:
    """Per kernel of a built library, its SASS as ``cuobjdump -sass`` lists
    it: ``[(address, opcode with modifiers, operands), ...]``."""
    from sda_tpu_torch.ops.cuda_build import _library_path

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", str(_library_path(source, tuple(defines)))],
                          capture_output=True, text=True, timeout=120, check=True)
    return parse_sass(proc.stdout)


def parse_sass(text: str) -> dict:
    """``cuobjdump -sass`` output -> ``{kernel label: [(address, opcode,
    operands), ...]}``."""
    listing, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = kernel_label(m.group(1))
            if current:
                listing[current] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m and current:
            listing[current].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return listing


def loops(instrs):
    """(head, tail) addresses of every loop: each branch back to an earlier
    (or the same) address."""
    return [(branch_target(args), addr) for addr, op, args in instrs
            if op == "BRA" and branch_target(args) <= addr]


def branch_target(args: str) -> int:
    """The address a branch's operands name."""
    return int(re.search(r"0x([0-9a-f]+)", args).group(1), 16)


def span(instrs, head: int, tail: int):
    """The instructions from address ``head`` to ``tail``, both included."""
    return [i for i in instrs if head <= i[0] <= tail]


def innermost_philox_loops(instrs):
    """The bodies of the loops that hold a Philox multiply and no other loop."""
    found = loops(instrs)
    return [span(instrs, h, t) for h, t in found
            if any(PHILOX_MUL_RE.search(a) for _, _, a in span(instrs, h, t))
            and not any(h <= h2 and t2 <= t and (h2, t2) != (h, t) for h2, t2 in found)]
