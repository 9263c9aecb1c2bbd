"""Device-health gate: check the GPU path against pinned answers and CPU
twins before it serves traffic.

Counterpart of the reference's ``provider/health.py``.  The probes:

* **ML-KEM-768**: a pinned known-answer vector (deterministic keygen and
  encaps from fixed seeds, FIPS 203) through the provider's device;
* **FrodoKEM, SHAKE sets**: the pinned FrodoKEM-640-SHAKE vector through
  the device (K9, K10 and K11 with K1); the 976 and 1344 sets then also run
  the round trip below with their own CPU twin, since their K9 and K10 are
  template instances of their own;
* **other KEMs** (the FrodoKEM AES sets, ML-KEM-512/1024): a round trip on
  the device provider, and its ciphertext decapsulated by the CPU twin;
* **signatures** (ML-DSA, SPHINCS+-SHA2): a round trip on the device
  provider and agreement with its CPU twin (device signatures verify on the
  CPU and a tampered one does not);
* **the fused handshake** (``BatchedFused``): one batch-1 ``keygen_sign``
  at the facade's offsets; the signature over the rendered template must
  verify on the CPU twin and the KEM key pair must round-trip through it;
* **the batched AEAD** (``BatchedAEAD``): the RFC 8439 §2.8.2 vector
  through the device seal, tamper rejection on open, and agreement with
  the scalar provider.

The CPU twins are the port's "cpu" providers (and the scalar AEAD), passed
in by the caller; nothing on the GPU routes to them.  With no breaker in
the port, a failed verdict raises from :func:`gate_facades`.  The
reference's on-disk verdict cache is not ported: every gate runs its
probes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
from typing import Any

import numpy as np
import torch

from ..kem import frodo, mlkem
from ..utils.wipe import wipe
from .base import (BatchedAEADOps, FusedHandshakeOps, KeyExchangeAlgorithm,
                   SignatureAlgorithm)

#: pinned ML-KEM-768 KAT: ML_KEM.KeyGen_internal / Encaps_internal with
#: d = 00..1f, z = 20..3f, m = 40..5f (FIPS 203)
_MLKEM768_KAT = {
    "d": bytes(range(32)),
    "z": bytes(range(32, 64)),
    "m": bytes(range(64, 96)),
    "ek_sha256": "0b7934c83125c788995e2ba6bd761e33046b3e40571be53e023309a29f398cc9",
    "ct_sha256": "dbf4e9aa48b078ad46ec1c9c47bda8c2d2fec9d0e7a21bd48d2238a2abedb856",
    "ss_hex": "9cddd089ffe70e3996e76f7c8d06746df34d07e8657bc0fcf2bb0e1c3084aea1",
}

#: pinned FrodoKEM-640-SHAKE KAT, the reference's (from its pure-Python
#: FrodoKEM): keygen seeds s = 00..0f, seedSE = 10..1f, z = 20..2f; encaps
#: mu = 30..3f
_FRODO640SHAKE_KAT = {
    "s": bytes(range(16)),
    "seed_se": bytes(range(16, 32)),
    "z": bytes(range(32, 48)),
    "mu": bytes(range(48, 64)),
    "pk_sha256": "e1933f44de4f6410af9155c4baa3b7454c6e93ec7701971daee3c7d2be3e03f3",
    "ct_sha256": "eefd2976cb8656e208526b33babf14eccd8f9a123db06e6032a30c449c1fc211",
    "ss_hex": "c2cb61ee5b4f5f6679259f09fc6b253b",
}

#: pinned RFC 8439 §2.8.2 AEAD vector (sha256 of ciphertext || tag)
_CHACHA_KAT = {
    "key": bytes(range(0x80, 0xA0)),
    "nonce": bytes([0x07, 0, 0, 0]) + bytes(range(0x40, 0x48)),
    "aad": bytes.fromhex("50515253c0c1c2c3c4c5c6c7"),
    "pt": (b"Ladies and Gentlemen of the class of '99: If I could offer "
           b"you only one tip for the future, sunscreen would be it."),
    "ct_tag_sha256": "4e54427e462f3beb69677d39865c5da8d57f603a85f7bf71368dce8ec9b9933c",
}


@dataclasses.dataclass
class HealthVerdict:
    family: str
    ok: bool
    detail: str

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def _check_mlkem_kat(algo) -> HealthVerdict:
    """The pinned FIPS 203 vector through ``algo``'s device, batch 1."""
    kat = _MLKEM768_KAT
    kg, enc, dec = mlkem.get("ML-KEM-768")

    def row(b: bytes) -> torch.Tensor:
        return torch.tensor(list(b), dtype=torch.uint8, device=algo.device)[None]

    ek, dk = kg(row(kat["d"]), row(kat["z"]))
    if hashlib.sha256(bytes(ek[0].cpu().numpy())).hexdigest() != kat["ek_sha256"]:
        return HealthVerdict(algo.name, False, "keygen KAT mismatch (ek)")
    ss, ct = enc(ek, row(kat["m"]))
    ss_b = bytes(ss[0].cpu().numpy())
    if hashlib.sha256(bytes(ct[0].cpu().numpy())).hexdigest() != kat["ct_sha256"]:
        return HealthVerdict(algo.name, False, "encaps KAT mismatch (ct)")
    if ss_b.hex() != kat["ss_hex"]:
        return HealthVerdict(algo.name, False, "encaps KAT mismatch (ss)")
    if bytes(dec(dk, ct)[0].cpu().numpy()) != ss_b:
        return HealthVerdict(algo.name, False, "decaps KAT mismatch")
    return HealthVerdict(algo.name, True, "FIPS 203 KAT ok (keygen/encaps/decaps)")


def _check_frodo_kat(algo) -> HealthVerdict:
    """The pinned FrodoKEM-640-SHAKE vector through ``algo``'s device, batch
    1.  The SHAKE sets share the kernels that make A's rows inside the
    products (K9, K10) and the sampler (K11), so one set stands for them."""
    kat = _FRODO640SHAKE_KAT
    kg, enc, dec = frodo.get("FrodoKEM-640-SHAKE")

    def row(b: bytes) -> torch.Tensor:
        return torch.tensor(list(b), dtype=torch.uint8, device=algo.device)[None]

    pk, sk = kg(row(kat["s"]), row(kat["seed_se"]), row(kat["z"]))
    if hashlib.sha256(bytes(pk[0].cpu().numpy())).hexdigest() != kat["pk_sha256"]:
        return HealthVerdict(algo.name, False, "keygen KAT mismatch (pk)")
    ct, ss = enc(pk, row(kat["mu"]))
    ss_b = bytes(ss[0].cpu().numpy())
    if hashlib.sha256(bytes(ct[0].cpu().numpy())).hexdigest() != kat["ct_sha256"]:
        return HealthVerdict(algo.name, False, "encaps KAT mismatch (ct)")
    if ss_b.hex() != kat["ss_hex"]:
        return HealthVerdict(algo.name, False, "encaps KAT mismatch (ss)")
    if bytes(dec(sk, ct)[0].cpu().numpy()) != ss_b:
        return HealthVerdict(algo.name, False, "decaps KAT mismatch")
    return HealthVerdict(algo.name, True, "FrodoKEM-640-SHAKE KAT ok (keygen/encaps/decaps)")


def _check_kem_roundtrip(algo, cpu_twin) -> HealthVerdict:
    """Device keygen/encaps/decaps round trip, and the device ciphertext
    decapsulated to the same secret by the CPU twin."""
    pk, sk = algo.generate_keypair()
    ss = b""
    try:
        ct, ss = algo.encapsulate(pk)
        if not hmac.compare_digest(algo.decapsulate(sk, ct), ss):
            return HealthVerdict(algo.name, False, "device decaps != device encaps")
        if cpu_twin is not None and not hmac.compare_digest(cpu_twin.decapsulate(sk, ct), ss):
            return HealthVerdict(algo.name, False, "cpu twin decaps disagrees with device encaps")
        agree = " + cpu agreement" if cpu_twin is not None else ""
        return HealthVerdict(algo.name, True, f"device roundtrip ok{agree}")
    finally:
        wipe(sk, ss)  # probe-only key material


def _check_sig_roundtrip(algo, cpu_twin) -> HealthVerdict:
    """Device sign/verify + CPU-twin verify + tamper rejection."""
    msg = b"qrp2p device-health probe"
    pk, sk = algo.generate_keypair()
    try:
        sig = algo.sign(sk, msg)
        if not algo.verify(pk, msg, sig):
            return HealthVerdict(algo.name, False, "device verify rejects device sign")
        if cpu_twin is not None and not cpu_twin.verify(pk, msg, sig):
            return HealthVerdict(algo.name, False, "cpu twin rejects the device signature")
        if algo.verify(pk, msg, bytes([sig[0] ^ 0xFF]) + sig[1:]):
            return HealthVerdict(algo.name, False, "device verify accepts tampered sig")
        agree = " + cpu agreement" if cpu_twin is not None else ""
        return HealthVerdict(algo.name, True, f"device sign/verify ok{agree}")
    finally:
        wipe(sk)  # probe-only key material


def _check_fused(facade, cpu_kem, cpu_sig) -> HealthVerdict:
    """The fused path (``BatchedFused``) is its own device code (the hex
    render into the template, the varlen transcript hash, the fused sign),
    so it can fail while the per-op families pass.  One batch-1
    ``keygen_sign`` at the facade's offsets: the signature over the
    rendered template must verify on the CPU twin and the KEM key pair
    must round-trip through the CPU twin."""
    fused = facade.algo
    name = f"fused:{fused.name}"
    sig_pk, sig_sk = cpu_sig.generate_keypair()
    ss = b""
    try:
        tmpl_len = min(fused.init_template_len,
                       facade.pk_off + 2 * fused.kem.public_key_len + 2)
        tmpl = b"{" + b"0" * (tmpl_len - 2) + b"}"
        pks, ksks, sigs = fused.keygen_sign_batch(np.frombuffer(sig_sk, np.uint8)[None],
                                                  [tmpl], facade.pk_off)
        pk, ksk = bytes(pks[0]), bytes(ksks[0])
        if not cpu_sig.verify(sig_pk, facade._render(tmpl, pk, facade.pk_off), sigs[0]):
            return HealthVerdict(name, False, "cpu twin rejects the fused keygen_sign "
                                 "signature (device render/hash/sign)")
        ct, ss = cpu_kem.encapsulate(pk)
        if not hmac.compare_digest(cpu_kem.decapsulate(ksk, ct), ss):
            return HealthVerdict(name, False, "fused keygen key pair fails the cpu KEM "
                                 "roundtrip")
        return HealthVerdict(name, True, "fused keygen_sign render/sign/keypair ok vs cpu")
    finally:
        wipe(sig_sk, ss)  # probe-only key material


def _check_aead(facade, scalar=None) -> HealthVerdict:
    """A batched AEAD facade's device path: the RFC 8439 §2.8.2 vector
    through the device seal, tamper rejection on open, and (given the
    scalar provider) the device-sealed frame opening on the scalar path."""
    name = f"aead:{facade.name}"
    kat = _CHACHA_KAT
    dev = facade.algo
    keys = np.frombuffer(kat["key"], np.uint8)[None]
    nonces = np.frombuffer(kat["nonce"], np.uint8)[None]
    sealed = dev.seal_batch(keys, nonces, [kat["pt"]], [kat["aad"]])[0]
    if hashlib.sha256(sealed).hexdigest() != kat["ct_tag_sha256"]:
        return HealthVerdict(name, False, "RFC 8439 §2.8.2 KAT mismatch")
    got = dev.open_batch(keys, nonces, [sealed], [kat["aad"]])[0]
    if not isinstance(got, bytes) or got != kat["pt"]:
        return HealthVerdict(name, False, "device open rejects device seal")
    bad = bytes([sealed[0] ^ 0xFF]) + sealed[1:]
    if not isinstance(dev.open_batch(keys, nonces, [bad], [kat["aad"]])[0], ValueError):
        return HealthVerdict(name, False, "device open accepts tampered ciphertext")
    if scalar is not None and scalar.open_(kat["key"], kat["nonce"], sealed,
                                           kat["aad"]) != kat["pt"]:
        return HealthVerdict(name, False, "scalar twin rejects device seal")
    agree = " + scalar agreement" if scalar is not None else ""
    return HealthVerdict(name, True, f"RFC 8439 KAT + tamper-reject ok{agree}")


def _probe(algo, cpu_twin) -> HealthVerdict:
    if algo.name == "ML-KEM-768":
        # the pinned vector covers keygen/encaps/decaps end to end
        return _check_mlkem_kat(algo)
    if algo.name.startswith("FrodoKEM") and algo.name.endswith("SHAKE"):
        verdict = _check_frodo_kat(algo)
        if not verdict.ok or algo.name == "FrodoKEM-640-SHAKE":
            return verdict
        # the pinned vector ran the 640 kernels; this set's own run here
        trip = _check_kem_roundtrip(algo, cpu_twin)
        return HealthVerdict(algo.name, trip.ok, f"{verdict.detail}; {algo.name} {trip.detail}")
    if isinstance(algo, KeyExchangeAlgorithm):
        return _check_kem_roundtrip(algo, cpu_twin)
    if isinstance(algo, SignatureAlgorithm):
        return _check_sig_roundtrip(algo, cpu_twin)
    raise ValueError(f"no device probe for {algo.name}")


def ensure_validated(algo, cpu_twin=None) -> HealthVerdict:
    """Run the health probe of one provider.  A probe that crashes is a
    failed verdict: a device that cannot run the probe serves no traffic."""
    if algo.backend == "cpu":
        return HealthVerdict(algo.name, True, "cpu backend; no device to gate")
    try:
        return _probe(algo, cpu_twin)
    except Exception as e:  # the verdict carries the failure to gate_facades
        return HealthVerdict(algo.name, False, f"probe crashed: {e!r}")


def _verdict(family: str, check, *args) -> HealthVerdict:
    try:
        verdict = check(*args)
    except Exception as e:  # as in ensure_validated
        verdict = HealthVerdict(family, False, f"probe crashed: {e!r}")
    verdict.family = family
    return verdict


def gate_facades(*facades, cpu_kem=None, cpu_sig=None, scalar=None) -> list[HealthVerdict]:
    """Check each batched facade's device path; raise RuntimeError on the
    first failed verdict, else return the verdicts.

    Takes ``BatchedKEM`` / ``BatchedSignature`` (probed with ``cpu_kem`` /
    ``cpu_sig`` as their CPU twins), ``BatchedFused`` (needs both twins)
    and ``BatchedAEAD`` (with ``scalar``, the scalar provider, for the
    agreement check); None entries are skipped."""
    out: list[HealthVerdict] = []
    for facade in facades:
        if facade is None:
            continue
        algo = facade.algo
        if isinstance(algo, FusedHandshakeOps):
            if cpu_kem is None or cpu_sig is None:
                raise ValueError("gating a fused facade needs cpu_kem and cpu_sig twins")
            verdict = _verdict(f"fused:{algo.name}@{facade.pk_off}", _check_fused,
                               facade, cpu_kem, cpu_sig)
        elif isinstance(algo, BatchedAEADOps):  # the data plane
            verdict = _verdict(f"aead:{facade.name}", _check_aead, facade, scalar)
        elif isinstance(algo, (KeyExchangeAlgorithm, SignatureAlgorithm)):
            twin = cpu_kem if isinstance(algo, KeyExchangeAlgorithm) else cpu_sig
            verdict = ensure_validated(algo, twin)
        else:
            raise TypeError(f"no health check for a facade over {type(algo).__name__}")
        out.append(verdict)
        if not verdict.ok:
            raise RuntimeError(f"device health {verdict.family} failed: {verdict.detail}")
    return out
