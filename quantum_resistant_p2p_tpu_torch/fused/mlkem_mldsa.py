"""ML-KEM x ML-DSA fused handshake programs: a handshake step's KEM op,
transcript hash and signature op in one batched call.

Counterpart of ``quantum_resistant_p2p_tpu/fused/mlkem_mldsa.py``.  Two of
the signed transcripts embed a device output (the hex of the fresh public
key or ciphertext), so the host passes the canonical-JSON transcript as a
*template* with a zeroed gap at a static offset; the program hex-encodes
its output into the gap and hashes the assembled message with the
variable-length sponge (``core.keccak.sponge_varlen``, kernel K1 with a
length per row on the GPU: the JSON tail differs per lane).  The rendered
message is byte-identical to what the separate-op path signs, so peers
cannot tell fused and unfused stacks apart.

Programs (roles as in the reference's ``app/messaging.py``):

* ``keygen_sign``        ke_init: ML-KEM keygen + sign(init transcript);
* ``encaps_verify_sign`` ke_init -> ke_response: verify(init) + encaps +
                         sign(response transcript);
* ``decaps_verify_sign`` ke_response -> ke_confirm: verify(response) +
                         decaps + sign(confirm transcript, whose mu the
                         host hashes and passes in).

The encaps and the response signature run whatever the verify says
(speculative, as in the reference); the caller discards them where ``ok``
is False.

Donation: the reference donates the incoming signature ``sig_in`` to the
output ``sigma`` (``donate_argnums=(4,)``).  The port does not alias them:
``sigma`` is a new tensor and ``sig_in`` is left as it was, so a caller may
read it after the call and nothing needs enforcing.
"""

from __future__ import annotations

import torch

from ..core import keccak
from ..kem import mlkem
from ..kem.params import PARAMS as _KEM_PARAMS
from ..sig import mldsa
from ..sig.params import PARAMS as _SIG_PARAMS


def encode_hex(x: torch.Tensor) -> torch.Tensor:
    """(..., L) uint8 -> (..., 2L) uint8 lowercase ASCII hex (``bytes.hex()``)."""
    nib = torch.stack([x >> 4, x & 0xF], dim=-1).to(torch.int32)
    ch = nib + 48 + torch.where(nib > 9, 39, 0)  # '0'..'9' then 'a'..'f'
    return ch.to(torch.uint8).reshape(x.shape[:-1] + (2 * x.shape[-1],))


def transcript_mu(sig_sk: torch.Tensor, msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    """mu = SHAKE256(tr || M', 64) of FIPS 204's pure mode on the device.

    M' = 0x00 || len(ctx) = 0x00 || msg (empty context); tr is
    sk[64:128].  ``msg`` is a (..., LMAX) template buffer whose true
    per-lane length is ``msg_len``; bytes past it are ignored."""
    tr = sig_sk[..., 64:128]
    frame = torch.zeros(msg.shape[:-1] + (2,), dtype=torch.uint8, device=msg.device)
    buf = torch.cat([tr.expand(msg.shape[:-1] + (64,)), frame, msg], dim=-1)
    return keccak.sponge_varlen(buf, (66 + msg_len).to(torch.int32), 136, 0x1F, 64)


def _insert_hex(tmpl: torch.Tensor, payload: torch.Tensor, off: int) -> torch.Tensor:
    """Hex-encode ``payload`` into the zeroed gap at static offset ``off``."""
    hexp = encode_hex(payload)
    return torch.cat([tmpl[..., :off], hexp, tmpl[..., off + hexp.shape[-1]:]], dim=-1)


def keygen_sign(kem_name: str, sig_name: str, pk_off: int, d, z, sig_sk, rnd, tmpl, msg_len):
    """ke_init: (d, z, sig_sk, rnd, tmpl, msg_len) -> (ek, dk, sigma, done).
    ``tmpl`` is the canonical init transcript with a 2 * ek_len zeroed gap
    at byte offset ``pk_off``."""
    ek, dk = mlkem.keygen(_KEM_PARAMS[kem_name], d, z)
    mu = transcript_mu(sig_sk, _insert_hex(tmpl, ek, pk_off), msg_len)
    sigma, done = mldsa.sign_mu(_SIG_PARAMS[sig_name], sig_sk, mu, rnd)
    return ek, dk, sigma, done


def encaps_verify_sign(kem_name: str, sig_name: str, ct_off: int, ek, m, peer_pk, mu_in,
                       sig_in, sig_sk, rnd, tmpl, msg_len):
    """ke_init -> ke_response: (ek, m, peer_pk, mu_in, sig_in, sig_sk, rnd,
    tmpl, msg_len) -> (ok, ct, shared_key, sigma, done)."""
    sp = _SIG_PARAMS[sig_name]
    ok = mldsa.verify_mu(sp, peer_pk, mu_in, sig_in)
    key, ct = mlkem.encaps(_KEM_PARAMS[kem_name], ek, m)
    mu = transcript_mu(sig_sk, _insert_hex(tmpl, ct, ct_off), msg_len)
    sigma, done = mldsa.sign_mu(sp, sig_sk, mu, rnd)
    return ok, ct, key, sigma, done


def decaps_verify_sign(kem_name: str, sig_name: str, dk, ct, peer_pk, mu_in, sig_in, sig_sk,
                       mu_out, rnd):
    """ke_response -> ke_confirm: (dk, ct, peer_pk, mu_in, sig_in, sig_sk,
    mu_out, rnd) -> (ok, shared_secret, sigma, done)."""
    sp = _SIG_PARAMS[sig_name]
    ok = mldsa.verify_mu(sp, peer_pk, mu_in, sig_in)
    ss = mlkem.decaps(_KEM_PARAMS[kem_name], dk, ct)
    sigma, done = mldsa.sign_mu(sp, sig_sk, mu_out, rnd)
    return ok, ss, sigma, done

