"""SdaClient: participant, clerk, recipient, and maintenance workflows.

Mirrors the `sda-client` crate's role traits against any SdaService:

- Maintenance  (client/src/profile.rs:21-50)
- Participating (participate.rs:13-117)
- Clerking     (clerk.rs:10-107)
- Receiving    (receive.rs:24-157)

The share/mask math itself lives in :mod:`sda_tpu_torch.sharing` /
:mod:`sda_tpu_torch.masking`; this module is the protocol choreography: fetch +
signature-verify keys, encrypt per clerk, poll jobs, reconstruct + unmask.

Port of the reference package's ``client``. Its four device call sites run
on the port: the participant's bulk share generation
(:meth:`TorchAggregationEngine.share_mxu`), the recipient's bulk
reconstruction (``engine.reconstruct`` or :func:`ops.modmat.modmat`), the
clerk's streamed fallback (:func:`sda_tpu_torch.engine.device_combine`)
and the recipient's mask combine (:func:`masking.masker_for_scheme`: the
ChaCha reveal is one B5 launch past 512 seeds at a pseudo-Mersenne p).
``device`` (the card unless ``"cpu"``) is where they run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sda_tpu_torch import protocol as proto
from sda_tpu_torch.client.crypto import CryptoModule, Keystore
from sda_tpu_torch.client.store import Filebased, MemoryStore
from sda_tpu_torch.fields import positive, trunc_mod
from sda_tpu_torch.service import SdaService
from sda_tpu_torch.utils.errors import Invalid

__all__ = ["SdaClient", "RecipientOutput", "new_agent", "Filebased", "MemoryStore", "Keystore"]

# Bulk-job size (total share elements = participants x per-clerk vector
# length) above which the streamed-device accumulate is used WHEN THE FUSED
# NATIVE OPEN+COMBINE DOES NOT RUN (``open_combine`` returns None). The
# reference's figure, kept: its measurement (the reference's
# tools/measure_combine_crossover.py) had the fused native open+combine
# beat the device route at every size, so bulk routing always prefers it.
# The port's own measurement is
# sda_tpu_torch/tools/measure_combine_crossover.py.
DEVICE_COMBINE_CROSSOVER = 20_000_000

# the clerk jobs each combine route has taken in this process (see
# SdaClient.process_clerking_job): "fused" (the native open+combine),
# "device" (streamed decrypt + device_combine) or "sequential" (decrypt,
# then the scheme's combine)
combine_routes = {"fused": 0, "device": 0, "sequential": 0}


def _streamed_decrypt(decryptor, encryptions, expected_len=None, chunk: int = 256):
    """Yield decrypted share vectors chunk-by-chunk with one-chunk lookahead:
    while :func:`sda_tpu_torch.engine.device_combine` accumulates chunk *i* on the
    accelerator, the native batch opener is already working on chunk *i+1*
    on the host cores — so a huge clerking job never materialises more than
    two chunks of plaintext shares (the streaming answer to clerk.rs:71-72).
    """
    from concurrent.futures import ThreadPoolExecutor

    encryptions = list(encryptions)
    d = expected_len  # scheme-derived per-clerk length when the caller knows it
    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = ex.submit(decryptor.decrypt_many, encryptions[:chunk])
        for start in range(0, len(encryptions), chunk):
            got = pending.result()
            nxt = encryptions[start + chunk : start + 2 * chunk]
            if nxt:
                pending = ex.submit(decryptor.decrypt_many, nxt)
            for v in got:
                # same dimension check the sequential combine fold applies
                # (combiner.rs semantics) — without it a ragged vector
                # surfaces as a raw numpy shape error from device_combine
                if d is None:
                    d = len(v)
                elif len(v) != d:
                    raise Invalid("Wrong dimension")
                yield v


@dataclass
class RecipientOutput:
    """Final revealed aggregate (receive.rs:7-21)."""

    modulus: int
    values: np.ndarray

    def positive(self) -> "RecipientOutput":
        return RecipientOutput(self.modulus, positive(self.values, self.modulus))


def new_agent(keystore: Keystore) -> proto.Agent:
    """Create an agent with a fresh signature keypair (profile.rs:10-18)."""
    crypto = CryptoModule(keystore)
    return proto.Agent(id=proto.new_id(), verification_key=crypto.new_signature_key())


class SdaClient:
    """Primary object for interacting with an SDA service (lib.rs:39-56).

    ``device_bulk_threshold``: when set, bulk field math beyond that many
    elements runs on the card — clerk-side combines via
    :func:`sda_tpu_torch.engine.device_combine` (the reference's clerk FIXME
    about an accumulating combiner, clerk.rs:71-72, answered with
    hardware) and participant-side share generation via the engine's
    modular matmul (the participate.rs:74-76 hot path at model scale).
    ``device``: where that math and the recipient's mask combine run (the
    card unless ``"cpu"``; with no card they raise).
    """

    def __init__(
        self,
        agent: proto.Agent,
        keystore: Keystore,
        service: SdaService,
        device_bulk_threshold: int | None = None,
        routing=None,
        device=None,
    ):
        self.agent = agent
        self.crypto = CryptoModule(keystore)
        self.service = service
        self.device_bulk_threshold = device_bulk_threshold
        self.device = device
        # measured host-vs-device policy for the masker/fallback bulk
        # decisions (sda_tpu_torch.routing.RoutingPolicy); None -> lazily built
        # from the probe when a bulk decision actually arises
        self.routing = routing
        self._engines: dict = {}
        # verified-encryption-key cache: the reference re-fetches and
        # re-verifies every key on every participation/job and carries a
        # FIXME about exactly that (signing/mod.rs:111 "no verification
        # caching"). Signed keys are create-only and content-addressed by
        # key id, so a (owner, key) pair that verified once verifies
        # forever — only SUCCESSES are cached (a failed verification is
        # re-tried on the next call). This turns the participant build
        # plane from ~20 HTTP GETs + 9 Ed25519 verifies per participation
        # into pure crypto (bench.py system_e2e measures the effect).
        self._verified_keys: dict[tuple[str, str], proto.EncryptionKey] = {}

    def _bulk_engine(self, scheme, dimension: int):
        """Cached engine per (scheme, dimension) configuration."""
        key = (scheme, dimension)
        engine = self._engines.get(key)
        if engine is None:
            from sda_tpu_torch.engine import TorchAggregationEngine

            engine = TorchAggregationEngine(scheme.device_spec(), dimension, device=self.device)
            self._engines[key] = engine
        return engine

    def _device_share_vector(self, scheme, masked_secrets) -> np.ndarray:
        """Participant-side bulk share generation on the card.

        Host-CSPRNG sharing randomness (protocol semantics preserved), the
        share transform as a device modular matmul (the 7-bit int8 path,
        ``torch._int_mm`` on the card, when the modulus allows), canonical
        ``[share_count, nb]`` outputs — the same contract as the host
        ``share_vector`` (batched.rs:19-52).
        """
        import torch

        engine = self._bulk_engine(scheme, len(masked_secrets))
        # integer arrays take encode_secrets' int64 path and, below 2^63,
        # the shares come back as int64: at a million dimensions the object
        # ints of the reference's round trip cost seconds a participation
        enc = engine.encode_secrets(np.asarray(masked_secrets)[None, :])
        ext = torch.cat([enc, engine.random_ext(1)], dim=2)
        share_fn = engine.share_mxu if engine.mxu is not None else engine.share
        out = share_fn(ext)
        small = engine.ctx.p < (1 << 63)
        shares = engine.ctx.decode_i64(out) if small else engine.decode_shares(out)  # [1, nb, n]
        return shares[0].T.copy()  # [n, nb]

    def _device_reconstruct(self, scheme, indexed_shares, dimension: int) -> np.ndarray:
        """Recipient-side bulk reconstruction on the card.

        All shares present -> the engine's precomputed inverse-transform
        matmul; a threshold subset (degraded committee, crypto.rs:147-153)
        -> the scheme's per-subset Lagrange matrix applied as the same
        device modular matmul. Returns the ``[dimension]`` canonical
        masked output."""
        from sda_tpu_torch.ops.modmat import modmat

        engine = self._bulk_engine(scheme, dimension)
        indexed_shares = sorted(indexed_shares, key=lambda t: t[0])
        indices = [i for i, _ in indexed_shares]
        small = engine.ctx.p < (1 << 63)  # the int64 paths, as in _device_share_vector
        combined = np.asarray([v for _, v in indexed_shares],
                              dtype=np.int64 if small else object).T  # [nb, s]
        encode = engine.ctx.encode_i64 if small else engine.ctx.encode
        limbs = encode(combined, engine.device)
        if indices == list(range(scheme.output_size)):
            out = engine.reconstruct(limbs)
        else:
            mat = np.asarray(scheme.reconstruct_matrix(indices), dtype=object)
            out = modmat(engine.ctx, limbs, engine.ctx.encode_mont(mat, engine.device))
        vals = engine.decode_output(out)  # int64 below 2^63
        return vals if small else np.array([int(v) for v in vals], dtype=np.int64)

    def _fallback_wants_device(self, est_elements: int) -> bool:
        """No-native-library clerk fallback: measured link-vs-fold decision
        when a routing policy is present; the static
        ``DEVICE_COMBINE_CROSSOVER`` constant otherwise (kept so the
        policy-free configuration keeps its r4-pinned behavior)."""
        if self.routing is not None:
            return self.routing.clerk_fallback_combine(est_elements) == "device"
        return est_elements >= DEVICE_COMBINE_CROSSOVER

    # ------------------------------------------------------- maintenance

    def upload_agent(self) -> None:
        self.service.create_agent(self.agent, self.agent)

    def new_encryption_key(self) -> str:
        return self.crypto.new_encryption_key()

    def upload_encryption_key(self, key_id: str) -> None:
        signed = self.crypto.sign_export(self.agent, key_id)
        if signed is None:
            raise Invalid("Could not sign encryption key")
        self.service.create_encryption_key(self.agent, signed)

    # ----------------------------------------------------- helper lookups

    def _verified_encryption_key(self, owner_id: str, key_id: str) -> proto.EncryptionKey:
        """Fetch a signed key + its owner, verify the signature
        (participate.rs:56-72 / 85-97 pattern); verified pairs are cached
        (see ``_verified_keys`` in ``__init__``)."""
        cached = self._verified_keys.get((owner_id, key_id))
        if cached is not None:
            return cached
        signed_key = self.service.get_encryption_key(self.agent, key_id)
        if signed_key is None:
            raise Invalid("Unknown encryption key")
        owner = self.service.get_agent(self.agent, owner_id)
        if owner is None:
            raise Invalid("Unknown agent")
        if not self.crypto.signature_is_valid(owner, signed_key):
            raise Invalid("Signature verification failed for key")
        key = signed_key.body.body
        self._verified_keys[(owner_id, key_id)] = key
        return key

    # ------------------------------------------------------ participating

    def new_participation(self, secrets, aggregation_id: str) -> proto.Participation:
        """Build a participation: mask, share, encrypt per clerk
        (participate.rs:37-113)."""
        secrets = np.asarray(secrets)
        aggregation = self.service.get_aggregation(self.agent, aggregation_id)
        if aggregation is None:
            raise Invalid("Could not find aggregation")
        if secrets.shape[0] != aggregation.vector_dimension:
            raise Invalid("The input length does not match the aggregation.")
        committee = self.service.get_committee(self.agent, aggregation_id)
        if committee is None:
            raise Invalid("Could not find committee")

        masker = self.crypto.new_secret_masker(aggregation.masking_scheme)
        recipient_mask, masked_secrets = masker.mask(secrets)

        recipient_encryption = None
        if len(recipient_mask) > 0:
            recipient_key = self._verified_encryption_key(
                aggregation.recipient, aggregation.recipient_key
            )
            mask_encryptor = self.crypto.new_share_encryptor(
                recipient_key, aggregation.recipient_encryption_scheme
            )
            recipient_encryption = mask_encryptor.encrypt(recipient_mask)

        generator = self.crypto.new_share_generator(aggregation.committee_sharing_scheme)
        if (
            self.device_bulk_threshold is not None
            and aggregation.vector_dimension >= self.device_bulk_threshold
            and aggregation.modulus % 2 == 1
            and hasattr(generator, "device_spec")
        ):
            shares_per_clerk = self._device_share_vector(generator, masked_secrets)
        else:
            shares_per_clerk = generator.share_vector(masked_secrets)  # [clerks, batch]

        clerk_encryptions = []
        for clerk_index, (clerk_id, clerk_key_id) in enumerate(committee.clerks_and_keys):
            clerk_key = self._verified_encryption_key(clerk_id, clerk_key_id)
            share_encryptor = self.crypto.new_share_encryptor(
                clerk_key, aggregation.committee_encryption_scheme
            )
            clerk_encryptions.append(
                (clerk_id, share_encryptor.encrypt(shares_per_clerk[clerk_index]))
            )

        return proto.Participation(
            id=proto.new_id(),
            participant=self.agent.id,
            aggregation=aggregation.id,
            recipient_encryption=recipient_encryption,
            clerk_encryptions=tuple(clerk_encryptions),
        )

    def upload_participation(self, participation: proto.Participation) -> None:
        self.service.create_participation(self.agent, participation)

    def participate(self, secrets, aggregation_id: str) -> None:
        self.upload_participation(self.new_participation(secrets, aggregation_id))

    # ----------------------------------------------------------- clerking

    def clerk_once(self) -> bool:
        """Poll + process + push one job (clerk.rs:25-37)."""
        job = self.service.get_clerking_job(self.agent, self.agent.id)
        if job is None:
            return False
        result = self.process_clerking_job(job)
        self.service.create_clerking_result(self.agent, result)
        return True

    def run_chores(self, max_iterations: int = -1) -> None:
        """Drain the job queue; negative means until empty (clerk.rs:39-57)."""
        if max_iterations < 0:
            while self.clerk_once():
                pass
        else:
            for _ in range(max_iterations):
                if not self.clerk_once():
                    break

    def process_clerking_job(self, job: proto.ClerkingJob) -> proto.ClerkingResult:
        """Decrypt all shares, combine, re-encrypt for recipient
        (clerk.rs:63-107)."""
        aggregation = self.service.get_aggregation(self.agent, job.aggregation)
        if aggregation is None:
            raise Invalid("Unknown aggregation")
        committee = self.service.get_committee(self.agent, job.aggregation)
        if committee is None:
            raise Invalid("Unknown committee")

        own_key_id = next(
            (key for cid, key in committee.clerks_and_keys if cid == self.agent.id), None
        )
        if own_key_id is None:
            raise Invalid("Could not find own encryption key in keyset")

        decryptor = self.crypto.new_share_decryptor(
            own_key_id, aggregation.committee_encryption_scheme
        )

        # Size-aware combine routing (the streaming answer to the clerk
        # FIXME at clerk.rs:71-72). Per-clerk share-vector length is fixed
        # by the scheme (batched.rs: ceil(d / input_size) batches), so the
        # job size is known before any box is opened:
        #  - bulk jobs: ONE fused native call opens + decodes + accumulates
        #    without ever materialising the share matrix
        #    (ShareDecryptor.open_combine) — CROSSOVER.json shows it beats
        #    the streamed-device route at every measured size;
        #  - fused route not run (open_combine returned None) + job above
        #    DEVICE_COMBINE_CROSSOVER elements: streamed decrypt + device
        #    accumulate (still far ahead of the pure-python fold at scale);
        #  - no threshold configured (or >=2^63 modulus): the reference's
        #    sequential decrypt-then-signed-fold, bit-for-bit
        #    (clerk.rs:78-86).
        share_len = -(-aggregation.vector_dimension
                      // aggregation.committee_sharing_scheme.input_size)
        est_elements = len(job.encryptions) * share_len
        combined = None
        if (
            self.device_bulk_threshold is not None
            and est_elements >= self.device_bulk_threshold
            and job.encryptions
            and aggregation.modulus < (1 << 63)
        ):
            combined = decryptor.open_combine(
                job.encryptions, aggregation.modulus, share_len
            )
            route = "fused"
            if combined is None and self._fallback_wants_device(est_elements):
                from sda_tpu_torch.engine import device_combine

                combined = device_combine(
                    aggregation.modulus,
                    _streamed_decrypt(decryptor, job.encryptions, share_len),
                    device=self.device,
                )
                route = "device"
        if combined is None:
            share_vectors = decryptor.decrypt_many(job.encryptions)
            combiner = self.crypto.new_share_combiner(aggregation.committee_sharing_scheme)
            combined = combiner.combine(share_vectors)
            route = "sequential"
        combine_routes[route] += 1

        recipient_key = self._verified_encryption_key(
            aggregation.recipient, aggregation.recipient_key
        )
        encryptor = self.crypto.new_share_encryptor(
            recipient_key, aggregation.recipient_encryption_scheme
        )
        return proto.ClerkingResult(
            job=job.id, clerk=job.clerk, encryption=encryptor.encrypt(combined)
        )

    # ---------------------------------------------------------- receiving

    def upload_aggregation(self, aggregation: proto.Aggregation) -> None:
        self.service.create_aggregation(self.agent, aggregation)

    def begin_aggregation(self, aggregation_id: str) -> None:
        """Elect a committee, blindly following the service suggestion
        (receive.rs:48-62)."""
        aggregation = self.service.get_aggregation(self.agent, aggregation_id)
        if aggregation is None:
            raise Invalid(f"Unknown aggregation, {aggregation_id}")
        candidates = self.service.suggest_committee(self.agent, aggregation_id)
        selected = [
            (c.id, c.keys[0])
            for c in candidates[: aggregation.committee_sharing_scheme.output_size]
        ]
        committee = proto.Committee(aggregation=aggregation_id, clerks_and_keys=tuple(selected))
        self.service.create_committee(self.agent, committee)

    def end_aggregation(self, aggregation_id: str) -> None:
        """Idempotent: create one snapshot if none exists (receive.rs:64-78)."""
        status = self.service.get_aggregation_status(self.agent, aggregation_id)
        if status is None:
            raise Invalid("Unknown aggregation")
        if len(status.snapshots) >= 1:
            return
        snapshot = proto.Snapshot(id=proto.new_id(), aggregation=aggregation_id)
        self.service.create_snapshot(self.agent, snapshot)

    def reveal_aggregation(self, aggregation_id: str) -> RecipientOutput:
        """Download, decrypt, reconstruct, unmask (receive.rs:80-157)."""
        aggregation = self.service.get_aggregation(self.agent, aggregation_id)
        if aggregation is None:
            raise Invalid(f"Unknown aggregation, {aggregation_id}")
        committee = self.service.get_committee(self.agent, aggregation_id)
        if committee is None:
            raise Invalid(f"Unknown committee, {aggregation_id}")
        status = self.service.get_aggregation_status(self.agent, aggregation_id)
        if status is None:
            raise Invalid("Unknown aggregation")
        snapshot = next((s for s in status.snapshots if s.result_ready), None)
        if snapshot is None:
            raise Invalid("Aggregation not ready")
        result = self.service.get_snapshot_result(self.agent, aggregation_id, snapshot.id)
        if result is None:
            raise Invalid("Missing aggregation result")

        decryptor = self.crypto.new_share_decryptor(
            aggregation.recipient_key, aggregation.recipient_encryption_scheme
        )

        # decrypt and combine masks (receive.rs:102-118); the ChaCha
        # re-expansion of every participant's seed runs on the card (the
        # receive.rs hot loop)
        if result.recipient_encryptions is None:
            mask = np.zeros(0, dtype=np.int64)
        else:
            decrypted_masks = decryptor.decrypt_many(result.recipient_encryptions)
            mask_combiner = self.crypto.new_secret_masker(
                aggregation.masking_scheme, self.device_bulk_threshold,
                routing=self.routing, device=self.device,
            )
            mask = mask_combiner.combine(decrypted_masks)

        # decrypt clerk results, map clerk -> committee index (receive.rs:127-138)
        clerk_order = [cid for cid, _ in committee.clerks_and_keys]
        indexed_shares = []
        for clerking_result in result.clerk_encryptions:
            try:
                clerk_index = clerk_order.index(clerking_result.clerk)
            except ValueError:
                raise Invalid(f"Missing clerk, {clerking_result.clerk}")
            indexed_shares.append((clerk_index, decryptor.decrypt(clerking_result.encryption)))

        reconstructor = self.crypto.new_secret_reconstructor(
            aggregation.committee_sharing_scheme
        )
        scheme_size = aggregation.committee_sharing_scheme.output_size
        indices = sorted(i for i, _ in indexed_shares)
        full_set = indices == list(range(scheme_size))
        valid_subset = (
            hasattr(reconstructor, "reconstruct_matrix")
            and len(set(indices)) == len(indices)
            and len(indices) >= getattr(reconstructor, "reconstruction_threshold", scheme_size)
        )
        if (
            self.device_bulk_threshold is not None
            and aggregation.vector_dimension >= self.device_bulk_threshold
            and aggregation.modulus < (1 << 63)
            and aggregation.modulus % 2 == 1
            and hasattr(reconstructor, "device_spec")
            and (full_set or valid_subset)
        ):
            masked_output = self._device_reconstruct(
                reconstructor, indexed_shares, aggregation.vector_dimension
            )
        else:
            masked_output = reconstructor.reconstruct(
                indexed_shares, dimension=aggregation.vector_dimension
            )

        unmasker = self.crypto.new_secret_masker(aggregation.masking_scheme)
        output = unmasker.unmask((mask, masked_output))
        return RecipientOutput(modulus=aggregation.modulus, values=np.asarray(output))
