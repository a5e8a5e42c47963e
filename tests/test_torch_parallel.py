"""The multi-device pipeline (``sda_tpu_torch.parallel``) against sda_tpu.

The same numpy inputs go through the reference's ``shard_map`` pipeline on
the virtual 8-device CPU mesh of ``tests/conftest.py`` (its kernel paths
run the interpret-mode Pallas kernels) and through the port's SPMD pipeline
in spawned gloo ranks, one process per mesh device. Every caller-randomness
path must give identical canonical limbs on the ``(p=2, d=2, c=2)`` and
``(p=3, d=1, c=1)`` meshes; the second takes ``psum_mod``'s branch for
axis sizes that are not powers of two. In PRNG mode the randomness cannot
match the reference's bit for bit, so the reveal must equal the modular
sum, the per-shard seeds must equal the reference's formula, and two
shards of one chunk must draw different randomness.

The ranks never load JAX: it is imported inside the reference-side
helpers only. Each rank group meets through a ``FileStore`` under the test's
temporary directory (no TCP port), every wait has a timeout, and the ranks
are terminated when anything fails, so a hung rank fails its test.
"""

import datetime
import functools
import multiprocessing
import queue
import time
import traceback

import numpy as np
import pytest
import torch

MESHES = {"2x2x2": {"p": 2, "d": 2, "c": 2}, "3x1x1": {"p": 3, "d": 1, "c": 1}}
P_CHUNK = {"2x2x2": 8, "3x1x1": 9}  # participants per chunk: whole shards
D = 12
LANES7, LANES8 = 128, 8
SEED = 5
RANK_TIMEOUT_S = 120  # the whole rank group, spawn to the last result
CALLER_PATHS = ["jnp", "mxu_ext", "mxu_streaming", "mxu8_ext", "mxu8_streaming", "degraded",
                "lane_batch"]
PRNG_PATHS = ["from_key", "mxu", "mxu_streaming_prng", "mxu8", "mxu8_streaming_prng"]
# per path: the field (p433 for the plain and 7-bit paths, the 63-bit
# special prime for the byte-limb paths, as tests/test_engine.py has them)
FIELD = {"jnp": "p433", "mxu_ext": "p433", "mxu_streaming": "p433", "from_key": "p433",
         "mxu": "p433", "mxu_streaming_prng": "p433"}


def _field(path):
    return FIELD.get(path, "p63")


@functools.lru_cache(maxsize=None)
def _scheme_params(field):
    from sda_tpu_torch.fields import find_special_prime_field

    if field == "p433":
        return 433, 354, 150
    return find_special_prime_field(63, 8, 9)


# ------------------------------------------------------------- inputs


COLLECTIVE_BLOCK = (6, 5)  # one rank's block (before the limb axis)


def _collective_input(mesh_name):
    """One canonical limb block per device, ``[n_dev, 6, 5, L]``, at the
    63-bit special prime."""
    from sda_tpu_torch.ops.limbs import LimbContext

    p = _scheme_params("p63")[0]
    n = int(np.prod(list(MESHES[mesh_name].values())))
    vals = np.random.default_rng(3).integers(0, p, size=(n,) + COLLECTIVE_BLOCK)
    return LimbContext.create(p).encode_i64(vals).numpy()


@functools.lru_cache(maxsize=None)
def _inputs(mesh_name):
    """numpy secrets and canonical randomness limbs for every path: three
    chunks' worth of participants per field, a second job for the lane
    batch, secrets whose participant shards are all alike (the per-shard
    PRNG check) and one limb block per device for the collectives."""
    from sda_tpu.engine import TpuAggregationEngine
    from sda_tpu.sharing import PackedShamirScheme

    pc = P_CHUNK[mesh_name]
    n_shards = MESHES[mesh_name]["p"] * MESHES[mesh_name]["c"]
    rng = np.random.default_rng(10 + pc)
    out = {}
    for field in ("p433", "p63"):
        p, w2, w3 = _scheme_params(field)
        ref = TpuAggregationEngine(PackedShamirScheme(3, 8, 4, p, w2, w3).device_spec(), D)
        for name, count in (("", 3 * pc), ("_b", pc)):
            out[field + name] = (rng.integers(0, min(p, 1 << 62), size=(count, D)),
                                 np.asarray(ref.random_ext(count, rng=rng)))
        alike = rng.integers(0, min(p, 1 << 62), size=(pc // n_shards, D))
        out[field + "_alike"] = np.concatenate([alike] * n_shards)
    out["blocks"] = _collective_input(mesh_name)
    out["numbered"] = np.arange(12 * 4, dtype=np.int64).reshape(12, 4)  # 12 rows: 4 or 3 shards
    return out


def _expect(secrets, p):
    return [int(x) % p for x in secrets.astype(object).sum(axis=0)]


# -------------------------------------------------- the port's ranks


def _run_port_paths(axis_sizes, inputs, mesh_name):
    """Every path of the port's pipeline on this rank; returns the global
    outputs as numpy arrays."""
    import torch.distributed as dist

    from sda_tpu_torch.engine import TorchAggregationEngine, limbs_from_numpy
    from sda_tpu_torch.parallel import ShardedAggregationPipeline, make_mesh
    from sda_tpu_torch.sharing import PackedShamirScheme

    mesh = make_mesh(axis_sizes, device_type="cpu")
    pc = P_CHUNK[mesh_name]
    res = {}
    for field in ("p433", "p63"):
        p, w2, w3 = _scheme_params(field)
        scheme = PackedShamirScheme(3, 8, 4, p, w2, w3)
        eng = TorchAggregationEngine(scheme.device_spec(), D, device="cpu")
        pipe = ShardedAggregationPipeline(eng, mesh)
        secrets, rand = inputs[field]
        enc = eng.encode_secrets(secrets)
        ext = torch.cat([enc, limbs_from_numpy(rand)], dim=2)
        r = res.setdefault(field, {})
        one = slice(0, pc)
        chunks = [slice(i * pc, (i + 1) * pc) for i in range(3)]
        if field == "p433":
            r["jnp"] = pipe.aggregate(enc[one], limbs_from_numpy(rand[one]))
            r["mxu_ext"] = pipe.aggregate_mxu_ext(eng.planar7_ext(ext[one], lanes=LANES7))
            r["mxu_streaming"] = pipe.aggregate_mxu_streaming(
                [eng.planar7_ext(ext[c], lanes=LANES7) for c in chunks], ext=True)
            r["from_key"] = pipe.aggregate_from_key(
                enc[one], torch.Generator().manual_seed(SEED))
            r["mxu"] = pipe.aggregate_mxu(eng.planar7_secrets(enc[one], lanes=LANES7), SEED)
            r["mxu_streaming_prng"] = pipe.aggregate_mxu_streaming(
                [lambda i: eng.planar7_secrets(enc[chunks[i]], lanes=LANES7)] * 3, seed0=SEED)
            part = pipe._mxu_partial(
                eng.planar7_secrets(eng.encode_secrets(inputs["p433_alike"]), lanes=LANES7),
                SEED, eng.spec.secret_count)
        else:
            r["mxu8_ext"] = pipe.aggregate_mxu8_streaming(
                [eng.planar8_ext(ext[one], lanes=LANES8)], ext=True)
            r["mxu8_streaming"] = pipe.aggregate_mxu8_streaming(
                [eng.planar8_ext(ext[c], lanes=LANES8) for c in chunks[:2]], ext=True)
            chunk = eng.planar8_ext(ext[one], lanes=LANES8)
            degraded = []
            for drop in range(scheme.share_count):
                subset = [i for i in range(scheme.share_count) if i != drop]
                degraded.append(pipe.aggregate_mxu8_streaming(
                    [chunk], ext=True, indices=subset,
                    subset_matrix=scheme.reconstruct_matrix(subset)))
            r["degraded"] = torch.stack(degraded)
            secrets_b, rand_b = inputs["p63_b"]
            ext_b = torch.cat([eng.encode_secrets(secrets_b), limbs_from_numpy(rand_b)], dim=2)
            r["lane_batch"] = pipe.aggregate_mxu8_streaming(
                [eng.concat_jobs_lanes([chunk, eng.planar8_ext(ext_b, lanes=LANES8)])],
                ext=True)
            r["mxu8"] = pipe.aggregate_mxu8(eng.planar8_secrets(enc[one], lanes=LANES8), SEED)
            r["mxu8_streaming_prng"] = pipe.aggregate_mxu8_streaming(
                [eng.planar8_secrets(enc[c], lanes=LANES8) for c in chunks[:2]], seed0=SEED)
            part = pipe.mxu8_partials(
                [eng.planar8_secrets(eng.encode_secrets(inputs["p63_alike"]), lanes=LANES8)],
                seed0=SEED)
        # every shard's partial sums of a chunk whose shards hold the same
        # secrets, in global rank order
        parts = [torch.empty_like(part) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, part.contiguous())
        r["partials"] = [x.numpy() for x in parts]
        r["shard_index"] = pipe.shard_index
        r["d_index"] = mesh.get_local_rank("d")
    out = {f: {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in r.items()}
           for f, r in res.items()}
    out["collectives"] = _run_collectives(mesh, axis_sizes, inputs["blocks"][dist.get_rank()])
    out["block"] = pipe.shard_planar(torch.from_numpy(inputs["numbered"])).numpy()
    return out


def _run_collectives(mesh, axis_sizes, block):
    """``psum_mod``, ``reduce_scatter_mod`` and ``all_gather_axis`` over
    every axis on this rank's block."""
    from sda_tpu_torch.ops.limbs import LimbContext
    from sda_tpu_torch.parallel import psum_mod, reduce_scatter_mod
    from sda_tpu_torch.parallel.collectives import all_gather_axis

    ctx = LimbContext.create(_scheme_params("p63")[0])
    x = torch.from_numpy(block)
    res = {}
    for axis in axis_sizes:
        res[("psum", axis)] = psum_mod(ctx, x, mesh, axis).numpy()
        res[("scatter", axis)] = reduce_scatter_mod(ctx, x, mesh, axis, 0).numpy()
        res[("gather", axis)] = all_gather_axis(x, mesh, axis, 1).numpy()
    return res


def _rank_main(rank, world, store_path, axis_sizes, inputs, mesh_name, out_q):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
        out_q.put((rank, "ok", _run_port_paths(axis_sizes, inputs, mesh_name)))
    except Exception:
        out_q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(target, world, args, timeout=RANK_TIMEOUT_S):
    """Run ``target(rank, world, *args, queue)`` in ``world`` spawned
    processes; returns ``{rank: result}``. Raises if a rank reports an
    error or the group outlasts ``timeout``; every rank still alive then is
    terminated."""
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(rank, world, *args, out_q), daemon=True)
             for rank in range(world)]
    for proc in procs:
        proc.start()
    got = {}
    try:
        deadline = time.monotonic() + timeout
        while len(got) < world:
            try:
                rank, status, payload = out_q.get(timeout=1.0)
            except queue.Empty:
                missing = sorted(set(range(world)) - set(got))
                dead = [r for r in missing if procs[r].exitcode is not None]
                if dead:
                    raise AssertionError(f"ranks {dead} exited with no result") from None
                if time.monotonic() > deadline:
                    raise AssertionError(f"ranks {missing} gave no result within {timeout} s"
                                         ) from None
                continue
            if status != "ok":
                raise AssertionError(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
        for proc in procs:
            proc.join(timeout=30)
        assert not any(proc.is_alive() for proc in procs), "a rank did not exit"
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
    return got


@pytest.fixture(scope="module", params=list(MESHES))
def port_run(request, tmp_path_factory):
    """One rank group per mesh shape runs every path once:
    ``(mesh name, per-rank results)``."""
    name = request.param
    axis_sizes = MESHES[name]
    world = int(np.prod(list(axis_sizes.values())))
    store = tmp_path_factory.mktemp(f"mesh{name}") / "store"
    return name, _spawn(_rank_main, world, (str(store), axis_sizes, _inputs(name), name))


# ------------------------------------------------------ the reference


@functools.lru_cache(maxsize=None)
def _ref_pipe(mesh_name, field):
    import jax

    from sda_tpu.engine import TpuAggregationEngine
    from sda_tpu.parallel import ShardedAggregationPipeline, make_mesh
    from sda_tpu.sharing import PackedShamirScheme

    if len(jax.devices()) < 8:
        raise AssertionError("the reference mesh needs the 8 virtual devices of conftest.py")
    axis_sizes = MESHES[mesh_name]
    n = int(np.prod(list(axis_sizes.values())))
    p, w2, w3 = _scheme_params(field)
    scheme = PackedShamirScheme(3, 8, 4, p, w2, w3)
    engine = TpuAggregationEngine(scheme.device_spec(), D)
    return scheme, engine, ShardedAggregationPipeline(
        engine, make_mesh(axis_sizes, devices=jax.devices()[:n]))


@functools.lru_cache(maxsize=None)
def _ref_output(mesh_name, path):
    """The reference pipeline's global output of one caller-randomness path
    (the degraded finishes' outputs stacked, one per dropped clerk)."""
    import jax.numpy as jnp

    field = _field(path)
    scheme, eng, pipe = _ref_pipe(mesh_name, field)
    inputs = _inputs(mesh_name)
    pc = P_CHUNK[mesh_name]
    secrets, rand = inputs[field]
    enc = jnp.asarray(eng.encode_secrets(secrets))
    ext = jnp.concatenate([enc, jnp.asarray(rand)], axis=2)
    chunks = [ext[i * pc : (i + 1) * pc] for i in range(3)]
    if path == "jnp":
        out = pipe.aggregate(pipe.shard_inputs(enc[:pc]), pipe.shard_inputs(jnp.asarray(rand[:pc])))
    elif path == "mxu_ext":
        out = pipe.aggregate_mxu_ext(pipe.shard_planar(eng.planar7_ext(chunks[0], lanes=LANES7)))
    elif path == "mxu_streaming":
        out = pipe.aggregate_mxu_streaming([eng.planar7_ext(c, lanes=LANES7) for c in chunks],
                                           ext=True)
    elif path == "mxu8_ext":
        out = pipe.aggregate_mxu8_streaming([eng.planar8_ext(chunks[0], lanes=LANES8)], ext=True)
    elif path == "mxu8_streaming":
        out = pipe.aggregate_mxu8_streaming([eng.planar8_ext(c, lanes=LANES8) for c in chunks[:2]],
                                            ext=True)
    elif path == "degraded":
        chunk = eng.planar8_ext(chunks[0], lanes=LANES8)
        outs = []
        for drop in range(scheme.share_count):
            subset = [i for i in range(scheme.share_count) if i != drop]
            outs.append(np.asarray(pipe.aggregate_mxu8_streaming(
                [chunk], ext=True, indices=subset,
                subset_matrix=scheme.reconstruct_matrix(subset))))
        return np.stack(outs)
    elif path == "lane_batch":
        secrets_b, rand_b = inputs["p63_b"]
        ext_b = jnp.concatenate([jnp.asarray(eng.encode_secrets(secrets_b)),
                                 jnp.asarray(rand_b)], axis=2)
        batched = eng.concat_jobs_lanes([eng.planar8_ext(chunks[0], lanes=LANES8),
                                         eng.planar8_ext(ext_b, lanes=LANES8)])
        out = pipe.aggregate_mxu8_streaming([batched], ext=True)
    else:
        raise KeyError(path)
    return np.asarray(out)


# -------------------------------------------------------------- tests


def _rank_outputs(results, field, path):
    """The output every rank returned, after checking they all agree."""
    outs = [results[rank][field][path] for rank in sorted(results)]
    for rank, out in enumerate(outs[1:], 1):
        np.testing.assert_array_equal(out, outs[0], err_msg=f"rank {rank} != rank 0")
    return outs[0]


@pytest.mark.parametrize("path", CALLER_PATHS)
def test_mesh_path_matches_reference(port_run, path):
    """Caller randomness: the port's global output, on every rank, has the
    reference pipeline's canonical limbs; the reveal is the modular sum."""
    mesh_name, results = port_run
    field = _field(path)
    got = _rank_outputs(results, field, path)
    want = _ref_output(mesh_name, path)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))
    from sda_tpu_torch.engine import TorchAggregationEngine
    from sda_tpu_torch.sharing import PackedShamirScheme

    p, w2, w3 = _scheme_params(field)
    eng = TorchAggregationEngine(PackedShamirScheme(3, 8, 4, p, w2, w3).device_spec(), D,
                                 device="cpu")
    inputs, pc = _inputs(mesh_name), P_CHUNK[mesh_name]
    secrets = inputs[field][0]
    n_part = {"mxu_streaming": 3 * pc, "mxu8_streaming": 2 * pc}.get(path, pc)
    want_sum = _expect(secrets[:n_part], p)
    if path == "lane_batch":
        nbp_job = got.shape[0] // 2
        jobs = [(got[:eng.nb], want_sum),
                (got[nbp_job : nbp_job + eng.nb], _expect(inputs["p63_b"][0], p))]
    else:
        jobs = [(g[:eng.nb], want_sum) for g in (got if path == "degraded" else [got])]
    for out, expect in jobs:
        assert [int(x) for x in eng.decode_output(torch.from_numpy(out.astype(np.int64)))] \
            == expect


@pytest.mark.parametrize("path", PRNG_PATHS)
def test_mesh_prng_paths_reveal_the_sum(port_run, path):
    """In-kernel (or generator) randomness: every rank returns the same
    output and it reveals the exact modular sum."""
    from sda_tpu_torch.engine import TorchAggregationEngine
    from sda_tpu_torch.sharing import PackedShamirScheme

    mesh_name, results = port_run
    field = _field(path)
    got = _rank_outputs(results, field, path)
    p, w2, w3 = _scheme_params(field)
    eng = TorchAggregationEngine(PackedShamirScheme(3, 8, 4, p, w2, w3).device_spec(), D,
                                 device="cpu")
    pc = P_CHUNK[mesh_name]
    n_part = {"mxu_streaming_prng": 3 * pc, "mxu8_streaming_prng": 2 * pc}.get(path, pc)
    out = torch.from_numpy(got[:eng.nb].astype(np.int64))
    assert [int(x) for x in eng.decode_output(out)] == _expect(
        _inputs(mesh_name)[field][0][:n_part], p)


@pytest.mark.parametrize("field", ["p433", "p63"])
def test_mesh_shards_draw_their_own_randomness(port_run, field):
    """Shards of one chunk holding the same secrets draw different
    randomness (their per-clerk partial sums differ); the shards of one
    participant block on different lane blocks share their seed, as in the
    reference."""
    mesh_name, results = port_run
    r0 = results[0][field]
    by_d = {}
    for rank in sorted(results):
        r = results[rank][field]
        by_d.setdefault(r["d_index"], []).append((r["shard_index"], r0["partials"][rank]))
    n_shards = MESHES[mesh_name]["p"] * MESHES[mesh_name]["c"]
    for shards in by_d.values():
        assert sorted(i for i, _ in shards) == list(range(n_shards))
        for a in range(len(shards)):
            for b in range(a + 1, len(shards)):
                assert not np.array_equal(shards[a][1], shards[b][1])


def test_shard_planar_is_the_reference_sharding(port_run):
    """Each rank's block of a global tensor is the block the reference's
    ``NamedSharding`` puts on the device at the same mesh position:
    participant rows over ``("p", "c")`` row-major, lanes over ``"d"``."""
    import jax

    mesh_name, results = port_run
    pipe = _ref_pipe(mesh_name, "p63")[2]
    devices = pipe.mesh.devices
    arr = jax.device_put(_inputs(mesh_name)["numbered"], pipe.planar_sharding)
    assert len(arr.addressable_shards) == len(results)
    for shard in arr.addressable_shards:
        coords = np.argwhere(devices == shard.device)[0]
        rank = int(np.ravel_multi_index(tuple(coords), devices.shape))
        np.testing.assert_array_equal(results[rank]["block"], np.asarray(shard.data),
                                      err_msg=f"rank {rank} at mesh position {tuple(coords)}")


def test_local_seed_is_the_reference_formula():
    """``local_seed`` against the reference's int32 ``jnp`` arithmetic
    (``sda_tpu/parallel/mesh.py``) on a table of cases, and distinct shards
    and seeds get disjoint windows."""
    import jax.numpy as jnp

    from sda_tpu_torch.parallel.mesh import local_seed

    def ref(seed, idx, n_shards, grid_n):
        windows = min(max(1, (1 << 31) // (n_shards * grid_n)), (1 << 31) - 1)
        return int(((jnp.asarray(seed, jnp.int32) % jnp.int32(windows)) * jnp.int32(n_shards)
                    + jnp.int32(idx)) * jnp.int32(grid_n))

    cases = [(0, 0, 1, 1), (5, 3, 4, 1), (7919 * 14, 2, 8, 652), (-1, 0, 4, 652),
             ((1 << 31) - 1, 7, 8, 652), (-(1 << 31), 1, 3, 2), (123456789, 5, 6, 1)]
    for case in cases:
        assert local_seed(*case) == ref(*case), case
    seeds = {local_seed(s, i, 4, 652) for s in range(3) for i in range(4)}
    assert len(seeds) == 12 and all(x % 652 == 0 for x in seeds)
    with pytest.raises(ValueError, match="int32"):
        local_seed(1 << 31, 0, 1, 1)


# ---------------------------------------------------- the collectives


def test_collectives_match_reference(port_run):
    """``psum_mod``, ``reduce_scatter_mod`` and ``all_gather_axis`` on every
    axis equal the reference's collectives under ``jax.shard_map``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from sda_tpu.ops.limbs import LimbContext
    from sda_tpu.parallel import make_mesh, psum_mod, reduce_scatter_mod
    from sda_tpu.parallel.collectives import all_gather_axis

    mesh_name, results = port_run
    axis_sizes = MESHES[mesh_name]
    blocks = _inputs(mesh_name)["blocks"]
    world = blocks.shape[0]
    mesh = make_mesh(axis_sizes, devices=jax.devices()[:world])
    ctx = LimbContext.create(_scheme_params("p63")[0])
    every = P(tuple(axis_sizes))
    ops = {
        "psum": lambda x, a: psum_mod(ctx, x, a),
        "scatter": lambda x, a: reduce_scatter_mod(ctx, x, a, 0),
        "gather": lambda x, a: all_gather_axis(x, a, 1),
    }
    keys = [(op, axis) for axis in axis_sizes for op in ops]
    # one shard_map (one compile) computes every collective on every axis
    wants = jax.shard_map(
        lambda x: tuple(ops[op](x[0], axis)[None] for op, axis in keys), mesh=mesh,
        in_specs=every, out_specs=tuple(every for _ in keys), check_vma=False,
    )(jnp.asarray(blocks.astype(np.uint32)))
    for (op, axis), want in zip(keys, wants):
        want = np.asarray(want)
        for rank in range(world):
            np.testing.assert_array_equal(results[rank]["collectives"][(op, axis)]
                                          .astype(np.int64),
                                          want[rank].astype(np.int64),
                                          err_msg=f"{op} over {axis}, rank {rank}")


# ------------------------------------------------------- failure cases


def _world1_rank(rank, world, out_q):
    """A process with no process group: the one-device mesh creates its own
    world of one; the mesh and the engine's single-device entry points
    agree; wrong sizes and devices raise."""
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        from sda_tpu_torch.engine import TorchAggregationEngine
        from sda_tpu_torch.fields import find_special_prime_field
        from sda_tpu_torch.parallel import ShardedAggregationPipeline, make_mesh
        from sda_tpu_torch.sharing import PackedShamirScheme

        res = {}
        try:
            make_mesh({"p": 2, "d": 1, "c": 1}, device_type="cpu")
        except RuntimeError as exc:
            res["no_group"] = str(exc)
        mesh = make_mesh({"p": 1, "d": 1, "c": 1}, device_type="cpu")
        res["world"] = dist.get_world_size()
        try:
            make_mesh({"p": 2, "d": 1, "c": 1}, device_type="cpu")
        except ValueError as exc:
            res["wrong_world"] = str(exc)
        try:
            ShardedAggregationPipeline(
                TorchAggregationEngine(PackedShamirScheme(3, 8, 4, 433, 354, 150).device_spec(),
                                       D, device="meta"), mesh)
        except ValueError as exc:
            res["wrong_device"] = str(exc)
        p, w2, w3 = find_special_prime_field(63, 8, 9)
        eng = TorchAggregationEngine(PackedShamirScheme(3, 8, 4, p, w2, w3).device_spec(), D,
                                     device="cpu")
        pipe = ShardedAggregationPipeline(eng, mesh)
        rng = np.random.default_rng(4)
        enc = eng.encode_secrets(rng.integers(0, 1 << 62, size=(16, D)))
        rand = eng.random_ext(16, rng=rng)
        ext = torch.cat([enc, rand], dim=2)
        chunks = [eng.planar8_ext(ext[:8], lanes=LANES8), eng.planar8_ext(ext[8:], lanes=LANES8)]
        res["jnp"] = torch.equal(pipe.aggregate(enc, rand), eng.aggregate(enc, rand))
        res["mxu8"] = torch.equal(
            pipe.aggregate_mxu8_streaming(chunks, ext=True)[:eng.nb],
            eng.aggregate_mxu8_kernel_streaming(chunks, 8, lanes=LANES8))
        ext7 = eng.planar7_ext(ext, lanes=LANES7)
        res["mxu"] = torch.equal(pipe.aggregate_mxu_ext(ext7)[:eng.nb],
                                 eng.aggregate_mxu_kernel(ext7, 0, 16, lanes=LANES7))
        out_q.put((rank, "ok", res))
    except Exception:
        out_q.put((rank, "error", traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_world_of_one_and_failures():
    """One process, no launcher: the mesh initialises its own world of one
    and equals the engine's entry points bit for bit; a mesh larger than
    the world raises, with or without a process group; an engine on
    another device type than the mesh's raises."""
    res = _spawn(_world1_rank, 1, ())[0]
    assert res["world"] == 1
    assert "initialised process group" in res["no_group"]
    assert "world has 1 ranks" in res["wrong_world"]
    assert "mesh on cpu" in res["wrong_device"]
    assert res["jnp"] and res["mxu8"] and res["mxu"]


def test_make_mesh_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from sda_tpu_torch.parallel import make_mesh

    for device_type in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh({"p": 1, "d": 1, "c": 1}, device_type=device_type)
    assert not torch.distributed.is_initialized()
