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
    """Importing every submodule loads neither JAX nor the JAX package, maps
    neither libsodium nor the native library, and builds nothing (no
    compiler process is started)."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, subprocess, sys
        before = set(sys.modules)  # an interpreter hook may preload modules

        def refuse(*args, **kwargs):
            raise AssertionError(f"a process was started at import: {args[:1]}")

        subprocess.Popen = subprocess.run = refuse
        import sda_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(sda_tpu_torch.__path__, "sda_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in set(sys.modules) - before if m.split(".")[0] in ("jax", "sda_tpu"))
        with open("/proc/self/maps") as maps:
            mapped = sorted({line.split()[-1] for line in maps
                             if "libsodium" in line or "libsda_native" in line})
        from sda_tpu_torch import sodium
        from sda_tpu_torch.utils import varint
        print(len(names), bad, mapped)
        assert not bad, bad
        assert not mapped, mapped
        assert sodium._lib.cache_info().currsize == 0
        assert varint._NATIVE is varint._UNLOADED
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    count = int(proc.stdout.split()[0])
    assert count >= 55  # every submodule of the slices was imported


def test_chacha_kernels_import_below_the_engine():
    """``ops`` sits below ``engine`` in the package's layers: a fresh import
    of the ChaCha kernels loads no engine."""
    code = textwrap.dedent(
        """
        import sys
        import sda_tpu_torch.ops.chacha_kernel
        assert "sda_tpu_torch.engine" not in sys.modules
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr


def test_port_binds_no_libsodium():
    """The port carries its own sealed boxes and signatures: no file of the
    package names libsodium's shared object or loads a library at run time
    with dlopen."""
    files = [p for p in (ROOT / "sda_tpu_torch").rglob("*")
             if p.is_file() and p.suffix in (".py", ".cpp", ".cu", ".h")]
    assert any(p.name == "nacl.cpp" for p in files)
    bad = [str(p.relative_to(ROOT)) for p in files
           if "libsodium.so" in p.read_text() or "dlopen" in p.read_text()]
    assert not bad, bad


def test_port_imports_without_requests_or_pymongo():
    """The HTTP proxy imports ``requests`` and the Mongo store ``pymongo``
    only when one is built: with both unimportable, every submodule still
    imports, and building either raises ImportError."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        sys.modules["requests"] = None  # makes "import requests" raise
        sys.modules["pymongo"] = None
        import sda_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(sda_tpu_torch.__path__, "sda_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert {"sda_tpu_torch.http.client", "sda_tpu_torch.stores_mongo"} <= set(names)
        from sda_tpu_torch.client.store import MemoryStore
        from sda_tpu_torch.http import HttpSdaService
        from sda_tpu_torch.stores_mongo import MongoStores
        for build in (lambda: HttpSdaService("http://127.0.0.1:1", MemoryStore()),
                      lambda: MongoStores("mongodb://127.0.0.1:1")):
            try:
                build()
            except ImportError:
                continue
            raise AssertionError("built without its package")
        print(len(names))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr


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


def test_new_entry_points_need_a_card_unless_asked_for_cpu():
    """The probe tools' measuring functions, the protocol client's device
    routes and masker_for_scheme: with no card they raise unless asked for
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from sda_tpu_torch import protocol as proto
    from sda_tpu_torch.client import Keystore, MemoryStore, SdaClient, new_agent
    from sda_tpu_torch.masking import ChaChaMasker, FullMasker, NoneMasker, masker_for_scheme
    from sda_tpu_torch.ops import probes
    from sda_tpu_torch.server import new_memory_server
    from sda_tpu_torch.tools import (
        measure_combine_crossover,
        measure_config3_variants,
        measure_lane_batch_floor,
        measure_latency_floor,
    )
    from sda_tpu_torch.utils.profiling import cuda_time_samples

    for measure in (lambda **kw: measure_latency_floor.measure(dimension=30, participants=4,
                                                               jobs=2, **kw),
                    lambda **kw: measure_lane_batch_floor.measure(dimension=30, participants=4,
                                                                  jobs=8, **kw),
                    lambda **kw: measure_config3_variants.measure(dimension=30, total=8, **kw),
                    lambda **kw: measure_combine_crossover.measure(shapes=((4, 5),), **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            measure()
    assert measure_latency_floor.measure(dimension=30, participants=4, jobs=2,
                                         device="cpu")["device"] == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_time_samples(lambda i: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_latency_floor.main()
    assert measure_combine_crossover.main() == 1  # reports the missing card, exits non-zero
    x = torch.zeros((8, 128), dtype=torch.int8)
    assert probes.probe_t1(x, 4, 1)[0].device.type == "cpu"

    p = (1 << 63) - 871
    for scheme, cls in ((proto.ChaChaMasking(p, 16, 128), ChaChaMasker),
                        (proto.FullMasking(p), FullMasker)):
        masker = masker_for_scheme(scheme)
        assert isinstance(masker, cls)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            masker.combine([masker.mask(np.arange(16))[0]] * 2)
        cpu = masker_for_scheme(scheme, device="cpu")
        assert len(cpu.combine([cpu.mask(np.arange(16))[0]] * 2)) == 16
    assert isinstance(masker_for_scheme(proto.NoMasking()), NoneMasker)

    service = new_memory_server()
    ks = Keystore(MemoryStore())
    recipient = SdaClient(new_agent(ks), ks, service, device_bulk_threshold=1)
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    agg = proto.Aggregation(
        id=proto.new_id(), title="no card", vector_dimension=4, modulus=433,
        recipient=recipient.agent.id, recipient_key=rkey, masking_scheme=proto.NoMasking(),
        committee_sharing_scheme=proto.AdditiveSharing(share_count=2, modulus=433),
    )
    recipient.upload_aggregation(agg)
    ks1 = Keystore(MemoryStore())
    clerk = SdaClient(new_agent(ks1), ks1, service)
    clerk.upload_agent()
    clerk.upload_encryption_key(clerk.new_encryption_key())
    recipient.begin_aggregation(agg.id)
    ks2 = Keystore(MemoryStore())
    participant = SdaClient(new_agent(ks2), ks2, service, device_bulk_threshold=1)
    participant.upload_agent()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        participant.participate(np.array([1, 2, 3, 4]), agg.id)
    participant.device = "cpu"
    participant.participate(np.array([1, 2, 3, 4]), agg.id)


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
