"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to drop to the CPU on their own."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_no_reference():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        before = set(sys.modules)  # an interpreter hook may preload modules
        import sda_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(sda_tpu_torch.__path__, "sda_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in set(sys.modules) - before
                     if m == "jax" or m.startswith("jax.") or m == "sda_tpu" or m.startswith("sda_tpu."))
        print(len(names), bad)
        assert not bad, bad
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    count = int(proc.stdout.split()[0])
    assert count >= 20  # every submodule of the slices was imported


def test_chip_smoke_imports_no_jax_and_no_reference():
    """Every import in chip_smoke.py, at any depth of the file, names
    neither jax nor the JAX package."""
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "sda_tpu_torch.models" in names  # the walk does see the nested imports
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "sda_tpu")]
    assert not bad, bad


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from sda_tpu_torch.engine import TorchAggregationEngine
    from sda_tpu_torch.models import FederatedAggregation
    from sda_tpu_torch.sharing import AdditiveScheme

    spec = AdditiveScheme(share_count=3, modulus=433).device_spec()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchAggregationEngine(spec, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedAggregation.packed_64bit(dimension=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedAggregation.additive_small(device="cuda")
    assert FederatedAggregation.packed_64bit(dimension=16, device="cpu").engine.device.type == "cpu"

    # the gen-3 and gen-1 entry points: asked for the CPU they run the plain
    # versions there; a tensor on neither the CPU nor a card takes no route
    eng = FederatedAggregation.packed_64bit(dimension=16, device="cpu").engine
    secrets = eng.encode_secrets(np.arange(3 * 16).reshape(3, 16))
    want = eng.ctx.sum_mod(secrets, axis=0)
    out = eng.aggregate_mxu_kernel(eng.planar7_secrets(secrets, lanes=128), 1, 3, lanes=128)
    assert out.device.type == "cpu" and torch.equal(out.to(torch.int64), want)
    out = eng.aggregate_fused(secrets, 1, rows=1)
    assert out.device.type == "cpu" and torch.equal(out, want)
    ext = torch.cat([secrets, eng.random_ext(3)], dim=2)
    assert eng.share_mxu(ext).device.type == "cpu"
    meta = torch.empty(ext.shape, dtype=torch.int64, device="meta")
    for call in (lambda: eng.aggregate_mxu_kernel(eng.planar7_ext(meta), 1, 3),
                 lambda: eng.aggregate_fused(meta[:, :, :3], 1, rows=1)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()

    from sda_tpu_torch.chacha import new_seed
    from sda_tpu_torch.engine import device_combine
    from sda_tpu_torch.masking import ChaChaMasker, FullMasker
    from sda_tpu_torch.ops.chacha_kernel import combine_masks_device, fold_masks_device
    from sda_tpu_torch.routing import RoutingPolicy

    p = (1 << 63) - 871
    seeds = [new_seed(128) for _ in range(3)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        combine_masks_device(seeds, 16, p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fold_masks_device(seeds, 16, p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_combine(p, [[1, 2], [3, 4]])
    for masker in (ChaChaMasker(p, 16, 128, routing=RoutingPolicy.force("device")),
                   ChaChaMasker(p, 16, 128)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            masker.combine([[1, 2, 3, 4]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FullMasker(p).combine([[1, 2], [3, 4]])


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    """Alone in a directory, chip_smoke.py exits non-zero and prints no
    result line."""
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
