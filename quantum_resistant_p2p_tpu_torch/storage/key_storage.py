"""Password-locked encrypted key vault.

Counterpart of the JAX package's ``storage/key_storage.py``, method for
method and in the same JSON format, so a vault moves between the packages in
both directions.  Every entry and the vault check are sealed with
``provider.symmetric.aes256gcm``: OpenSSL's AES-256-GCM where the
``cryptography`` wheel is installed, the port's own ``core.aesgcm``
otherwise.  The KDF is the JAX package's: Argon2id where ``cryptography``
provides it, else scrypt from ``hashlib``.  A vault made with Argon2id
cannot be opened without the wheel (``unlock`` raises ``KeyStorageError``
saying so); the port has no Argon2id of its own.

Design, as there (capability parity with the original project's
crypto/key_storage.py: Argon2id KDF, per-entry AES-GCM, HMAC-derived opaque
entry IDs, purpose keys, password change, destructive reset, key history,
on-demand decrypt, best-effort zeroization):

* One master key derived from the password — Argon2id when the linked OpenSSL
  provides it (>= 3.2), otherwise scrypt (n=2^15, r=8, p=1).  The KDF and its
  parameters are recorded in the vault header, so vaults remain readable
  across hosts.
* Every entry is AES-256-GCM encrypted under an HKDF-derived entry key; the
  entry's on-disk ID is HMAC-SHA256(index_key, name) so names never appear in
  plaintext.  The (name, value) pair lives inside the ciphertext, which lets
  the vault enumerate its own entries after unlock.
* ALL entries — including purpose keys — are re-encrypted on password change,
  so everything survives it.
"""

from __future__ import annotations

import base64
import hashlib
import hmac as hmac_mod
import logging
import os
import secrets
import time
from pathlib import Path
from typing import Any, Iterable

from ..provider.symmetric import aes256gcm
from .secure_file import AtomicFile

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1
_CHECK_PLAINTEXT = b"qrp2p-tpu-vault-check-v1"


class KeyStorageError(Exception):
    pass


class _NoArgon2id(KeyStorageError):
    """The vault's KDF is Argon2id and this machine has no ``cryptography``."""


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode("ascii")


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def _derive_key(password: str, salt: bytes, kdf: dict) -> bytes:
    algo = kdf["algo"]
    if algo == "argon2id":
        try:
            from cryptography.hazmat.primitives.kdf.argon2 import Argon2id
        except ImportError as e:
            raise _NoArgon2id(
                "this vault's KDF is Argon2id, which needs the 'cryptography' "
                "package; it is not installed here") from e

        return Argon2id(
            salt=salt,
            length=32,
            iterations=kdf["iterations"],
            lanes=kdf["lanes"],
            memory_cost=kdf["memory_cost"],
        ).derive(password.encode())
    if algo == "scrypt":
        return hashlib.scrypt(
            password.encode(), salt=salt, n=kdf["n"], r=kdf["r"], p=kdf["p"], dklen=32,
            maxmem=256 * 1024 * 1024,
        )
    raise KeyStorageError(f"unknown KDF {algo!r}")


def _default_kdf() -> dict:
    try:
        from cryptography.hazmat.primitives.kdf.argon2 import Argon2id

        Argon2id(salt=b"\0" * 16, length=32, iterations=1, lanes=1, memory_cost=32)
        return {"algo": "argon2id", "iterations": 3, "lanes": 4, "memory_cost": 100 * 1024}
    except Exception:  # qrlint: disable=broad-except  — capability probe: any failure (old OpenSSL, import error) means "use scrypt", which IS the handling
        return {"algo": "scrypt", "n": 2**15, "r": 8, "p": 1}


def _subkey(master: bytes, label: bytes) -> bytes:
    return hmac_mod.new(master, b"qrp2p-tpu/" + label, hashlib.sha256).digest()


def get_app_data_dir() -> Path:
    d = Path(os.environ.get("QRP2P_TPU_HOME", Path.home() / ".qrp2p_tpu"))
    d.mkdir(parents=True, exist_ok=True)
    os.chmod(d, 0o700)
    return d


class KeyStorage:
    """Encrypted vault holding signature keypairs, shared-key history, purpose keys."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = Path(path) if path else get_app_data_dir() / "vault.json"
        self._file = AtomicFile(self.path)
        self._master: bytes | None = None
        self._entry_key: bytes | None = None
        self._index_key: bytes | None = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def is_unlocked(self) -> bool:
        return self._master is not None

    def unlock(self, password: str) -> bool:
        """Unlock (or initialize) the vault.  Returns False on a bad password."""
        vault = self._file.read_json()
        if vault is None:
            self._init_vault(password)
            return True
        try:
            master = _derive_key(password, _unb64(vault["salt"]), vault["kdf"])
            check = vault["check"]
            aes256gcm(master).decrypt(_unb64(check["nonce"]), _unb64(check["ct"]), None)
        except _NoArgon2id:
            raise
        except Exception:  # qrlint: disable=broad-except  — unlock contract: wrong password and corrupt vault both map to False; logging the cause would oracle which one it was
            return False
        self._set_master(master)
        return True

    def lock(self) -> None:
        self._zeroize()

    def _init_vault(self, password: str) -> None:
        salt = secrets.token_bytes(16)
        kdf = _default_kdf()
        master = _derive_key(password, salt, kdf)
        nonce = secrets.token_bytes(12)
        ct = aes256gcm(master).encrypt(nonce, _CHECK_PLAINTEXT, None)
        self._file.write_json(
            {
                "format_version": FORMAT_VERSION,
                "salt": _b64(salt),
                "kdf": kdf,
                "check": {"nonce": _b64(nonce), "ct": _b64(ct)},
                "entries": {},
            }
        )
        self._set_master(master)
        logger.info("initialized new key vault at %s (kdf=%s)", self.path, kdf["algo"])

    def _set_master(self, master: bytes) -> None:
        self._master = master
        self._entry_key = _subkey(master, b"entry")
        self._index_key = _subkey(master, b"index")

    def _require_unlocked(self) -> None:
        if not self.is_unlocked:
            raise KeyStorageError("vault is locked")

    # -- entries ------------------------------------------------------------

    def _entry_id(self, name: str) -> str:
        assert self._index_key is not None
        return hmac_mod.new(self._index_key, name.encode(), hashlib.sha256).hexdigest()[:32]

    def _encrypt_entry(self, name: str, value: Any) -> dict:
        assert self._entry_key is not None
        import json

        payload = json.dumps({"name": name, "value": value}).encode()
        nonce = secrets.token_bytes(12)
        ct = aes256gcm(self._entry_key).encrypt(nonce, payload, None)
        return {"nonce": _b64(nonce), "ct": _b64(ct), "created_at": time.time()}

    def _decrypt_entry(self, name: str, blob: dict) -> Any:
        assert self._entry_key is not None
        import json

        pt = aes256gcm(self._entry_key).decrypt(_unb64(blob["nonce"]), _unb64(blob["ct"]), None)
        rec = json.loads(pt)
        if rec["name"] != name:
            raise KeyStorageError("entry name mismatch (index collision?)")
        return rec["value"]

    def store(self, name: str, value: Any) -> None:
        """Store a JSON-serializable value (bytes values: use store_bytes)."""
        self._require_unlocked()
        vault = self._file.read_json()
        vault["entries"][self._entry_id(name)] = self._encrypt_entry(name, value)
        self._file.write_json(vault)

    def retrieve(self, name: str, default: Any = None) -> Any:
        self._require_unlocked()
        vault = self._file.read_json()
        blob = vault["entries"].get(self._entry_id(name))
        if blob is None:
            return default
        try:
            return self._decrypt_entry(name, blob)
        except Exception as e:
            logger.error("failed to decrypt entry %r: %s", name, e)
            return default

    def delete(self, name: str) -> bool:
        self._require_unlocked()
        vault = self._file.read_json()
        removed = vault["entries"].pop(self._entry_id(name), None) is not None
        if removed:
            self._file.write_json(vault)
        return removed

    def store_bytes(self, name: str, value: bytes) -> None:
        self.store(name, {"__bytes__": _b64(value)})

    def retrieve_bytes(self, name: str) -> bytes | None:
        v = self.retrieve(name)
        if isinstance(v, dict) and "__bytes__" in v:
            return _unb64(v["__bytes__"])
        return None

    def list_entries(self) -> list[dict]:
        """Decrypt and enumerate all entries: [{name, created_at}]."""
        self._require_unlocked()
        import json

        vault = self._file.read_json()
        out = []
        assert self._entry_key is not None
        for blob in vault["entries"].values():
            try:
                pt = aes256gcm(self._entry_key).decrypt(
                    _unb64(blob["nonce"]), _unb64(blob["ct"]), None
                )
            except Exception as e:
                logger.error("skipping undecryptable entry: %s", e)
                continue
            out.append({"name": json.loads(pt)["name"], "created_at": blob["created_at"]})
        return out

    # -- purpose keys -------------------------------------------------------

    def get_or_create_purpose_key(self, purpose: str, length: int = 32) -> bytes:
        """Stable random key for an internal purpose (e.g. the audit log).

        Survives password changes (all entries are re-encrypted on change).
        """
        self._require_unlocked()
        name = f"purpose_key_{purpose}"
        existing = self.retrieve_bytes(name)
        if existing is not None:
            return existing
        key = secrets.token_bytes(length)
        self.store_bytes(name, key)
        return key

    # Alias matching the reference's API (crypto/key_storage.py:259).
    get_or_create_persistent_key = get_or_create_purpose_key

    # -- shared-key history (reference: key_storage.py:678-782) -------------

    KEY_HISTORY_PREFIX = "peer_shared_key_"

    def save_peer_shared_key(self, peer_id: str, key: bytes, algo: str) -> str:
        name = f"{self.KEY_HISTORY_PREFIX}{peer_id}_{time.time():.6f}"
        self.store(name, {"key": _b64(key), "algorithm": algo, "peer_id": peer_id})
        return name

    def list_key_history(self, peer_id: str | None = None) -> list[dict]:
        out = []
        for ent in self.list_entries():
            if not ent["name"].startswith(self.KEY_HISTORY_PREFIX):
                continue
            if peer_id is not None and not ent["name"].startswith(
                self.KEY_HISTORY_PREFIX + peer_id + "_"
            ):
                continue
            out.append(ent)
        return sorted(out, key=lambda e: e["created_at"], reverse=True)

    def get_key_history_value(self, name: str) -> dict | None:
        """On-demand decrypt of a historic shared key (audit this at call sites)."""
        return self.retrieve(name)

    def delete_key_history(self, name: str) -> bool:
        return self.delete(name)

    def clear_key_history(self) -> int:
        n = 0
        for ent in self.list_key_history():
            n += self.delete(ent["name"])
        return n

    # -- password management -------------------------------------------------

    def change_password(self, old_password: str, new_password: str) -> bool:
        """Re-derive the master key and re-encrypt every entry."""
        self._require_unlocked()
        vault = self._file.read_json()
        try:
            old_master = _derive_key(old_password, _unb64(vault["salt"]), vault["kdf"])
        except Exception:  # qrlint: disable=broad-except  — same contract as unlock(): any KDF failure means "wrong password" -> False
            return False
        import hmac

        # constant-time: a byte-wise != would leak how much of the derived
        # master key matches (qrflow flow-secret-compare)
        if not hmac.compare_digest(old_master, self._master):
            return False
        # Decrypt all entries under the old keys.
        plain: list[tuple[str, Any]] = []
        import json

        assert self._entry_key is not None
        for blob in vault["entries"].values():
            try:
                pt = aes256gcm(self._entry_key).decrypt(
                    _unb64(blob["nonce"]), _unb64(blob["ct"]), None
                )
                rec = json.loads(pt)
                plain.append((rec["name"], rec["value"]))
            except Exception as e:
                logger.error("entry lost during password change: %s", e)
        salt = secrets.token_bytes(16)
        kdf = _default_kdf()
        master = _derive_key(new_password, salt, kdf)
        self._set_master(master)
        nonce = secrets.token_bytes(12)
        ct = aes256gcm(master).encrypt(nonce, _CHECK_PLAINTEXT, None)
        self._file.write_json(
            {
                "format_version": FORMAT_VERSION,
                "salt": _b64(salt),
                "kdf": kdf,
                "check": {"nonce": _b64(nonce), "ct": _b64(ct)},
                "entries": {
                    self._entry_id(name): self._encrypt_entry(name, value)
                    for name, value in plain
                },
            }
        )
        return True

    def reset_storage(self, new_password: str, create_backup: bool = False) -> None:
        """Destructive reset: drop every entry, re-key the vault."""
        if create_backup and self.path.exists():
            backup = Path(str(self.path) + f".pre-reset-{int(time.time())}")
            backup.write_bytes(self.path.read_bytes())
        self._zeroize()
        if self.path.exists():
            self.path.unlink()
        self._init_vault(new_password)

    # -- hygiene -------------------------------------------------------------

    def _zeroize(self) -> None:
        # Python can't reliably scrub immutable bytes; drop references so the
        # GC can reclaim them and nothing in this object can decrypt further.
        self._master = None
        self._entry_key = None
        self._index_key = None
