"""Wire-level protocol: resources, crypto scheme descriptors, JSON serde.

Mirrors the `sda-protocol` crate (protocol/src/): the same
resources (resources.rs), scheme enums (crypto.rs), and serde JSON encoding
conventions (helpers.rs):

- ids are hyphenated UUID strings (helpers.rs:19-86);
- binary blobs and fixed byte arrays are base64 strings
  (helpers.rs:176-216, byte_arrays.rs:3-99);
- Rust enums use serde external tagging: unit variants are bare strings
  (``"Sodium"``, ``"None"``), struct variants are single-key objects
  (``{"Full": {"modulus": 433}}``);
- the signature payload is the canonical compact JSON encoding of the signed
  body in declaration field order (helpers.rs:138-142) — reproduced by
  :func:`canonical`.

The cryptographic configuration travels inside the :class:`Aggregation`
resource itself; it is the single source of truth every party reads
(resources.rs:44-67).
"""

from __future__ import annotations

import base64
import json
import uuid
from dataclasses import dataclass, field
from typing import Optional

from sda_tpu_torch.sharing import AdditiveScheme, PackedShamirScheme
from sda_tpu_torch.utils.errors import Invalid

__all__ = [
    "new_id",
    "canonical",
    "Binary",
    "Encryption",
    "EncryptionKey",
    "Signature",
    "SigningKey",
    "VerificationKey",
    "NoMasking",
    "FullMasking",
    "ChaChaMasking",
    "AdditiveSharing",
    "PackedShamirSharing",
    "SodiumEncryptionScheme",
    "Labelled",
    "Signed",
    "Agent",
    "Profile",
    "Aggregation",
    "ClerkCandidate",
    "Committee",
    "Participation",
    "Snapshot",
    "ClerkingJob",
    "ClerkingResult",
    "AggregationStatus",
    "SnapshotStatus",
    "SnapshotResult",
    "AuthToken",
    "Pong",
    "masking_scheme_to_obj",
    "masking_scheme_from_obj",
    "sharing_scheme_to_obj",
    "sharing_scheme_from_obj",
]


def new_id() -> str:
    """Fresh random id (uuid_id! macro semantics, helpers.rs:19-34)."""
    return str(uuid.uuid4())


def canonical(obj_like) -> bytes:
    """Canonical signing bytes: compact JSON in declaration order.

    Matches ``Sign::canonical() = serde_json::to_vec`` (helpers.rs:138-142).
    """
    obj = obj_like.to_obj() if hasattr(obj_like, "to_obj") else obj_like
    return json.dumps(obj, separators=(",", ":"), ensure_ascii=False).encode()


def _b64e(data: bytes) -> str:
    return base64.b64encode(data).decode()


def _b64d(s: str) -> bytes:
    return base64.b64decode(s.encode())


# ------------------------------------------------------------------ crypto


@dataclass(frozen=True)
class Binary:
    """Base64-serialised binary blob (helpers.rs:176-216)."""

    data: bytes

    def to_obj(self):
        return _b64e(self.data)

    @classmethod
    def from_obj(cls, obj):
        return cls(_b64d(obj))


@dataclass(frozen=True)
class Encryption:
    """Ciphertext; only the Sodium variant exists (crypto.rs:8-11)."""

    data: bytes

    def to_obj(self):
        return {"Sodium": _b64e(self.data)}

    @classmethod
    def from_obj(cls, obj):
        return cls(_b64d(obj["Sodium"]))


def _fixed_bytes_variant(name: str, size: int):
    """Factory for `Sodium`-tagged fixed byte arrays (byte_arrays.rs B! macro)."""

    @dataclass(frozen=True)
    class _Wrapper:
        data: bytes

        def __post_init__(self):
            if len(self.data) != size:
                raise Invalid(f"{name} must be {size} bytes")

        def to_obj(self):
            return {"Sodium": _b64e(self.data)}

        @classmethod
        def from_obj(cls, obj):
            return cls(_b64d(obj["Sodium"]))

    _Wrapper.__name__ = name
    _Wrapper.__qualname__ = name
    return _Wrapper


EncryptionKey = _fixed_bytes_variant("EncryptionKey", 32)  # crypto.rs:15-18
Signature = _fixed_bytes_variant("Signature", 64)  # crypto.rs:22-25
SigningKey = _fixed_bytes_variant("SigningKey", 64)  # crypto.rs:29-32
VerificationKey = _fixed_bytes_variant("VerificationKey", 32)  # crypto.rs:36-39


# ------------------------------------------------- masking scheme variants


@dataclass(frozen=True)
class NoMasking:
    """LinearMaskingScheme::None (crypto.rs:45-46)."""

    @property
    def has_mask(self) -> bool:
        return False


@dataclass(frozen=True)
class FullMasking:
    """LinearMaskingScheme::Full (crypto.rs:49-51)."""

    modulus: int

    @property
    def has_mask(self) -> bool:
        return True


@dataclass(frozen=True)
class ChaChaMasking:
    """LinearMaskingScheme::ChaCha (crypto.rs:57-63)."""

    modulus: int
    dimension: int
    seed_bitsize: int

    @property
    def has_mask(self) -> bool:
        return True


def masking_scheme_to_obj(scheme):
    if isinstance(scheme, NoMasking):
        return "None"
    if isinstance(scheme, FullMasking):
        return {"Full": {"modulus": scheme.modulus}}
    if isinstance(scheme, ChaChaMasking):
        return {
            "ChaCha": {
                "modulus": scheme.modulus,
                "dimension": scheme.dimension,
                "seed_bitsize": scheme.seed_bitsize,
            }
        }
    raise Invalid(f"unknown masking scheme {scheme!r}")


def masking_scheme_from_obj(obj):
    if obj == "None":
        return NoMasking()
    if "Full" in obj:
        return FullMasking(modulus=obj["Full"]["modulus"])
    if "ChaCha" in obj:
        c = obj["ChaCha"]
        return ChaChaMasking(
            modulus=c["modulus"], dimension=c["dimension"], seed_bitsize=c["seed_bitsize"]
        )
    raise Invalid(f"unknown masking scheme {obj!r}")


# ------------------------------------------------- sharing scheme variants


@dataclass(frozen=True)
class AdditiveSharing:
    """LinearSecretSharingScheme::Additive (crypto.rs:82-88)."""

    share_count: int
    modulus: int

    @property
    def input_size(self) -> int:
        return 1

    @property
    def output_size(self) -> int:
        return self.share_count

    @property
    def privacy_threshold(self) -> int:
        return self.share_count - 1

    @property
    def reconstruction_threshold(self) -> int:
        return self.share_count

    def engine(self) -> AdditiveScheme:
        return AdditiveScheme(share_count=self.share_count, modulus=self.modulus)


@dataclass(frozen=True)
class PackedShamirSharing:
    """LinearSecretSharingScheme::PackedShamir (crypto.rs:99-114)."""

    secret_count: int
    share_count: int
    privacy_threshold: int
    prime_modulus: int
    omega_secrets: int
    omega_shares: int

    @property
    def input_size(self) -> int:
        return self.secret_count

    @property
    def output_size(self) -> int:
        return self.share_count

    @property
    def reconstruction_threshold(self) -> int:
        # crypto.rs:151: privacy_threshold + secret_count
        return self.privacy_threshold + self.secret_count

    def engine(self) -> PackedShamirScheme:
        return PackedShamirScheme(
            secret_count=self.secret_count,
            share_count=self.share_count,
            privacy_threshold=self.privacy_threshold,
            prime_modulus=self.prime_modulus,
            omega_secrets=self.omega_secrets,
            omega_shares=self.omega_shares,
        )


def sharing_scheme_to_obj(scheme):
    if isinstance(scheme, AdditiveSharing):
        return {"Additive": {"share_count": scheme.share_count, "modulus": scheme.modulus}}
    if isinstance(scheme, PackedShamirSharing):
        return {
            "PackedShamir": {
                "secret_count": scheme.secret_count,
                "share_count": scheme.share_count,
                "privacy_threshold": scheme.privacy_threshold,
                "prime_modulus": scheme.prime_modulus,
                "omega_secrets": scheme.omega_secrets,
                "omega_shares": scheme.omega_shares,
            }
        }
    raise Invalid(f"unknown sharing scheme {scheme!r}")


def sharing_scheme_from_obj(obj):
    if "Additive" in obj:
        a = obj["Additive"]
        return AdditiveSharing(share_count=a["share_count"], modulus=a["modulus"])
    if "PackedShamir" in obj:
        p = obj["PackedShamir"]
        return PackedShamirSharing(
            secret_count=p["secret_count"],
            share_count=p["share_count"],
            privacy_threshold=p["privacy_threshold"],
            prime_modulus=p["prime_modulus"],
            omega_secrets=p["omega_secrets"],
            omega_shares=p["omega_shares"],
        )
    raise Invalid(f"unknown sharing scheme {obj!r}")


@dataclass(frozen=True)
class SodiumEncryptionScheme:
    """AdditiveEncryptionScheme::Sodium (crypto.rs:161-163)."""

    @property
    def batch_size(self) -> int:
        return 1


def encryption_scheme_to_obj(scheme):
    if isinstance(scheme, SodiumEncryptionScheme):
        return "Sodium"
    raise Invalid(f"unknown encryption scheme {scheme!r}")


def encryption_scheme_from_obj(obj):
    if obj == "Sodium":
        return SodiumEncryptionScheme()
    raise Invalid(f"unknown encryption scheme {obj!r}")


# -------------------------------------------------------- generic wrappers


@dataclass(frozen=True)
class Labelled:
    """Message labelled by an id (helpers.rs:146-172)."""

    id: str
    body: object

    def to_obj(self):
        body = self.body.to_obj() if hasattr(self.body, "to_obj") else self.body
        return {"id": self.id, "body": body}

    @classmethod
    def from_obj(cls, obj, body_cls=None):
        body = obj["body"]
        if body_cls is not None:
            body = body_cls.from_obj(body)
        return cls(id=obj["id"], body=body)


@dataclass(frozen=True)
class Signed:
    """Signed message wrapper (helpers.rs:100-127): signature + signer + body."""

    signature: object  # Signature
    signer: str  # AgentId
    body: object

    def to_obj(self):
        body = self.body.to_obj() if hasattr(self.body, "to_obj") else self.body
        return {"signature": self.signature.to_obj(), "signer": self.signer, "body": body}

    @classmethod
    def from_obj(cls, obj, body_from_obj=None):
        body = obj["body"]
        if body_from_obj is not None:
            body = body_from_obj(body)
        return cls(
            signature=Signature.from_obj(obj["signature"]),
            signer=obj["signer"],
            body=body,
        )

    @property
    def id(self):
        return self.body.id


def signed_encryption_key_from_obj(obj) -> Signed:
    """SignedEncryptionKey = Signed<Labelled<EncryptionKeyId, EncryptionKey>>."""
    return Signed.from_obj(obj, body_from_obj=lambda b: Labelled.from_obj(b, EncryptionKey))


# -------------------------------------------------------------- resources


@dataclass(frozen=True)
class Agent:
    """Fundamental identity resource (resources.rs:12-17)."""

    id: str
    verification_key: Labelled  # Labelled<VerificationKeyId, VerificationKey>

    def to_obj(self):
        return {"id": self.id, "verification_key": self.verification_key.to_obj()}

    @classmethod
    def from_obj(cls, obj):
        return cls(
            id=obj["id"],
            verification_key=Labelled.from_obj(obj["verification_key"], VerificationKey),
        )


@dataclass(frozen=True)
class Profile:
    """Extended trust profile (resources.rs:24-35)."""

    owner: str
    name: Optional[str] = None
    twitter_id: Optional[str] = None
    keybase_id: Optional[str] = None
    website: Optional[str] = None

    def to_obj(self):
        return {
            "owner": self.owner,
            "name": self.name,
            "twitter_id": self.twitter_id,
            "keybase_id": self.keybase_id,
            "website": self.website,
        }

    @classmethod
    def from_obj(cls, obj):
        return cls(
            owner=obj["owner"],
            name=obj.get("name"),
            twitter_id=obj.get("twitter_id"),
            keybase_id=obj.get("keybase_id"),
            website=obj.get("website"),
        )


@dataclass(frozen=True)
class Aggregation:
    """The central configuration object (resources.rs:44-67)."""

    id: str
    title: str
    vector_dimension: int
    modulus: int
    recipient: str  # AgentId
    recipient_key: str  # EncryptionKeyId
    masking_scheme: object
    committee_sharing_scheme: object
    recipient_encryption_scheme: object = field(default_factory=SodiumEncryptionScheme)
    committee_encryption_scheme: object = field(default_factory=SodiumEncryptionScheme)

    def to_obj(self):
        return {
            "id": self.id,
            "title": self.title,
            "vector_dimension": self.vector_dimension,
            "modulus": self.modulus,
            "recipient": self.recipient,
            "recipient_key": self.recipient_key,
            "masking_scheme": masking_scheme_to_obj(self.masking_scheme),
            "committee_sharing_scheme": sharing_scheme_to_obj(self.committee_sharing_scheme),
            "recipient_encryption_scheme": encryption_scheme_to_obj(
                self.recipient_encryption_scheme
            ),
            "committee_encryption_scheme": encryption_scheme_to_obj(
                self.committee_encryption_scheme
            ),
        }

    @classmethod
    def from_obj(cls, obj):
        return cls(
            id=obj["id"],
            title=obj["title"],
            vector_dimension=obj["vector_dimension"],
            modulus=obj["modulus"],
            recipient=obj["recipient"],
            recipient_key=obj["recipient_key"],
            masking_scheme=masking_scheme_from_obj(obj["masking_scheme"]),
            committee_sharing_scheme=sharing_scheme_from_obj(obj["committee_sharing_scheme"]),
            recipient_encryption_scheme=encryption_scheme_from_obj(
                obj["recipient_encryption_scheme"]
            ),
            committee_encryption_scheme=encryption_scheme_from_obj(
                obj["committee_encryption_scheme"]
            ),
        )


@dataclass(frozen=True)
class ClerkCandidate:
    """Suggested committee member (resources.rs:74-79)."""

    id: str
    keys: tuple  # EncryptionKeyIds

    def to_obj(self):
        return {"id": self.id, "keys": list(self.keys)}

    @classmethod
    def from_obj(cls, obj):
        return cls(id=obj["id"], keys=tuple(obj["keys"]))


@dataclass(frozen=True)
class Committee:
    """Elected committee: ordered (clerk, key) pairs (resources.rs:83-88)."""

    aggregation: str
    clerks_and_keys: tuple  # of (AgentId, EncryptionKeyId)

    def to_obj(self):
        return {
            "aggregation": self.aggregation,
            "clerks_and_keys": [list(p) for p in self.clerks_and_keys],
        }

    @classmethod
    def from_obj(cls, obj):
        return cls(
            aggregation=obj["aggregation"],
            clerks_and_keys=tuple((a, k) for a, k in obj["clerks_and_keys"]),
        )


@dataclass(frozen=True)
class Participation:
    """A participant's encrypted input (resources.rs:92-108)."""

    id: str
    participant: str
    aggregation: str
    recipient_encryption: Optional[Encryption]
    clerk_encryptions: tuple  # of (AgentId, Encryption)

    def to_obj(self):
        return {
            "id": self.id,
            "participant": self.participant,
            "aggregation": self.aggregation,
            "recipient_encryption": (
                self.recipient_encryption.to_obj() if self.recipient_encryption else None
            ),
            "clerk_encryptions": [[a, e.to_obj()] for a, e in self.clerk_encryptions],
        }

    @classmethod
    def from_obj(cls, obj):
        rec = obj.get("recipient_encryption")
        return cls(
            id=obj["id"],
            participant=obj["participant"],
            aggregation=obj["aggregation"],
            recipient_encryption=Encryption.from_obj(rec) if rec else None,
            clerk_encryptions=tuple(
                (a, Encryption.from_obj(e)) for a, e in obj["clerk_encryptions"]
            ),
        )


@dataclass(frozen=True)
class Snapshot:
    """Consistency point freezing a participation set (resources.rs:116-121)."""

    id: str
    aggregation: str

    def to_obj(self):
        return {"id": self.id, "aggregation": self.aggregation}

    @classmethod
    def from_obj(cls, obj):
        return cls(id=obj["id"], aggregation=obj["aggregation"])


@dataclass(frozen=True)
class ClerkingJob:
    """Partial aggregation job for one clerk (resources.rs:128-139)."""

    id: str
    clerk: str
    aggregation: str
    snapshot: str
    encryptions: tuple  # of Encryption

    def to_obj(self):
        return {
            "id": self.id,
            "clerk": self.clerk,
            "aggregation": self.aggregation,
            "snapshot": self.snapshot,
            "encryptions": [e.to_obj() for e in self.encryptions],
        }

    @classmethod
    def from_obj(cls, obj):
        return cls(
            id=obj["id"],
            clerk=obj["clerk"],
            aggregation=obj["aggregation"],
            snapshot=obj["snapshot"],
            encryptions=tuple(Encryption.from_obj(e) for e in obj["encryptions"]),
        )


@dataclass(frozen=True)
class ClerkingResult:
    """Result of a clerking job (resources.rs:146-153)."""

    job: str
    clerk: str
    encryption: Encryption

    def to_obj(self):
        return {"job": self.job, "clerk": self.clerk, "encryption": self.encryption.to_obj()}

    @classmethod
    def from_obj(cls, obj):
        return cls(
            job=obj["job"], clerk=obj["clerk"], encryption=Encryption.from_obj(obj["encryption"])
        )


@dataclass(frozen=True)
class SnapshotStatus:
    """resources.rs:166-175."""

    id: str
    number_of_clerking_results: int
    result_ready: bool

    def to_obj(self):
        return {
            "id": self.id,
            "number_of_clerking_results": self.number_of_clerking_results,
            "result_ready": self.result_ready,
        }

    @classmethod
    def from_obj(cls, obj):
        return cls(
            id=obj["id"],
            number_of_clerking_results=obj["number_of_clerking_results"],
            result_ready=obj["result_ready"],
        )


@dataclass(frozen=True)
class AggregationStatus:
    """resources.rs:157-163."""

    aggregation: str
    number_of_participations: int
    snapshots: tuple  # of SnapshotStatus

    def to_obj(self):
        return {
            "aggregation": self.aggregation,
            "number_of_participations": self.number_of_participations,
            "snapshots": [s.to_obj() for s in self.snapshots],
        }

    @classmethod
    def from_obj(cls, obj):
        return cls(
            aggregation=obj["aggregation"],
            number_of_participations=obj["number_of_participations"],
            snapshots=tuple(SnapshotStatus.from_obj(s) for s in obj["snapshots"]),
        )


@dataclass(frozen=True)
class SnapshotResult:
    """resources.rs:179-188."""

    snapshot: str
    number_of_participations: int
    clerk_encryptions: tuple  # of ClerkingResult
    recipient_encryptions: Optional[tuple]  # of Encryption

    def to_obj(self):
        return {
            "snapshot": self.snapshot,
            "number_of_participations": self.number_of_participations,
            "clerk_encryptions": [c.to_obj() for c in self.clerk_encryptions],
            "recipient_encryptions": (
                [e.to_obj() for e in self.recipient_encryptions]
                if self.recipient_encryptions is not None
                else None
            ),
        }

    @classmethod
    def from_obj(cls, obj):
        rec = obj.get("recipient_encryptions")
        return cls(
            snapshot=obj["snapshot"],
            number_of_participations=obj["number_of_participations"],
            clerk_encryptions=tuple(ClerkingResult.from_obj(c) for c in obj["clerk_encryptions"]),
            recipient_encryptions=(
                tuple(Encryption.from_obj(e) for e in rec) if rec is not None else None
            ),
        )


@dataclass(frozen=True)
class AuthToken:
    """AuthToken = Labelled<AgentId, String> (stores.rs:7)."""

    id: str  # AgentId
    body: str  # the secret

    def to_obj(self):
        return {"id": self.id, "body": self.body}

    @classmethod
    def from_obj(cls, obj):
        return cls(id=obj["id"], body=obj["body"])


@dataclass(frozen=True)
class Pong:
    """ping response (methods.rs:7-10)."""

    running: bool

    def to_obj(self):
        return {"running": self.running}

    @classmethod
    def from_obj(cls, obj):
        return cls(running=obj["running"])
