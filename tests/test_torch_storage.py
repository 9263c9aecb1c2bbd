"""The port's storage (``quantum_resistant_p2p_tpu_torch/storage/``) against
the JAX package's, on the CPU.

* The 12 tests of ``tests/test_storage.py``, on the port's ``KeyStorage``,
  ``SecureLogger`` and ``AtomicFile``, each twice: sealing with OpenSSL
  (the ``cryptography`` wheel) and with the port's own ``core.aesgcm`` (the
  wheel hidden from ``provider.symmetric``, as on a machine without it).
* A vault written by either package unlocks and reads in the other, both
  ways: entries, bytes, a purpose key, key history, and a changed password.
  The same for ``SecureLogger`` files.
* In a fresh interpreter with every ``cryptography`` import blocked (the
  GPU machine has no wheel): a vault and a log round-trip on the port's
  AES-256-GCM with the scrypt KDF, the JAX package (with the wheel, here)
  reads both, and a vault whose KDF is Argon2id raises ``KeyStorageError``
  saying it needs the wheel.

Tolerance: exact.  The JAX package's storage needs the wheel, so this
module skips without it; it imports no JAX program.
"""

from __future__ import annotations

import base64
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("cryptography")  # the JAX package's vault and log, and OpenSSL

from quantum_resistant_p2p_tpu import storage as ref_storage
from quantum_resistant_p2p_tpu_torch.provider import symmetric
from quantum_resistant_p2p_tpu_torch.storage import (AtomicFile, KeyStorage, KeyStorageError,
                                                     SecureLogger)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(params=["OpenSSL", "port"])
def aead(request, monkeypatch):
    """Which AES-256-GCM the port's storage seals with."""
    if request.param == "port":
        monkeypatch.setattr(symmetric, "_aead", None)
    return request.param


@pytest.fixture
def vault(tmp_path, aead):
    ks = KeyStorage(tmp_path / "vault.json")
    assert ks.unlock("hunter2-long-pass")
    return ks


# -- mirrors of tests/test_storage.py ---------------------------------------------


def test_unlock_wrong_password(tmp_path, aead):
    ks = KeyStorage(tmp_path / "vault.json")
    assert ks.unlock("correct horse")
    ks.lock()
    assert not ks.is_unlocked
    ks2 = KeyStorage(tmp_path / "vault.json")
    assert not ks2.unlock("wrong pass")
    assert ks2.unlock("correct horse")


def test_store_retrieve_delete(vault):
    vault.store("alpha", {"x": 1})
    assert vault.retrieve("alpha") == {"x": 1}
    vault.store_bytes("blob", b"\x00\x01\xff")
    assert vault.retrieve_bytes("blob") == b"\x00\x01\xff"
    assert vault.delete("alpha")
    assert vault.retrieve("alpha") is None
    assert not vault.delete("alpha")


def test_names_not_on_disk(vault, tmp_path):
    vault.store("super_secret_entry_name", {"v": 1})
    raw = (tmp_path / "vault.json").read_text()
    assert "super_secret_entry_name" not in raw


def test_purpose_key_stable_and_survives_password_change(vault):
    k1 = vault.get_or_create_purpose_key("audit")
    assert len(k1) == 32
    assert vault.get_or_create_purpose_key("audit") == k1
    assert vault.change_password("hunter2-long-pass", "new-password-9")
    assert vault.get_or_create_purpose_key("audit") == k1


def test_change_password_requires_old(vault):
    assert not vault.change_password("nope", "x")


def test_key_history(vault):
    vault.save_peer_shared_key("peerA", b"k" * 32, "ML-KEM-768")
    time.sleep(0.01)
    vault.save_peer_shared_key("peerA", b"j" * 32, "ML-KEM-768")
    vault.save_peer_shared_key("peerB", b"i" * 32, "ML-KEM-1024")
    hist = vault.list_key_history()
    assert len(hist) == 3
    hist_a = vault.list_key_history("peerA")
    assert len(hist_a) == 2
    newest = vault.get_key_history_value(hist_a[0]["name"])
    assert newest["peer_id"] == "peerA"
    assert vault.clear_key_history() == 3
    assert vault.list_key_history() == []


def test_reset_storage(vault, tmp_path):
    vault.store("gone", {"v": 1})
    vault.reset_storage("fresh-password")
    assert vault.retrieve("gone") is None
    ks2 = KeyStorage(tmp_path / "vault.json")
    assert not ks2.unlock("hunter2-long-pass")
    assert ks2.unlock("fresh-password")


def test_locked_raises(tmp_path, aead):
    ks = KeyStorage(tmp_path / "vault.json")
    with pytest.raises(KeyStorageError):
        ks.store("a", 1)


def test_atomic_file_backup_recovery(tmp_path, aead):
    af = AtomicFile(tmp_path / "data.json")
    af.write_json({"gen": 1})
    af.write_json({"gen": 2})
    # corrupt the primary; read should fall back to the .bak (gen 1)
    (tmp_path / "data.json").write_text("{truncated")
    assert af.read_json() == {"gen": 1}


def test_secure_logger_roundtrip_and_metrics(tmp_path, aead):
    key = os.urandom(32)
    sl = SecureLogger(key, tmp_path)
    sl.log_event("message_sent", size=100, algorithm="AES-256-GCM")
    sl.log_event("message_received", size=40, algorithm="AES-256-GCM")
    sl.log_event("key_exchange", algorithm="ML-KEM-768", peer="p1")
    events = sl.get_events()
    assert len(events) == 3
    assert sl.get_events(event_type="key_exchange")[0]["peer"] == "p1"
    summary = sl.get_event_summary()
    assert summary["message_sent"] == 1
    m = sl.get_security_metrics()
    assert m["bytes_sent"] == 100 and m["bytes_received"] == 40
    assert m["algorithms_used"]["AES-256-GCM"] == 2
    assert sl.clear_logs() == 1
    assert sl.get_events() == []


def test_secure_logger_corruption_recovery(tmp_path, aead):
    key = os.urandom(32)
    sl = SecureLogger(key, tmp_path)
    sl.log_event("a")
    path = next(tmp_path.glob("*.qlog"))
    good = path.read_bytes()
    # splice garbage between two valid records
    sl.log_event("b")
    full = path.read_bytes()
    second = full[len(good):]
    path.write_bytes(good + b"\xde\xad\xbe\xef" + second)
    events = sl.get_events()
    assert [e["event_type"] for e in events] == ["a", "b"]


def test_secure_logger_wrong_key_reads_nothing(tmp_path, aead):
    sl = SecureLogger(os.urandom(32), tmp_path)
    sl.log_event("a")
    sl2 = SecureLogger(os.urandom(32), tmp_path)
    assert sl2.get_events() == []


# -- between the packages -----------------------------------------------------------

PACKAGES = {"port": (KeyStorage, SecureLogger),
            "reference": (ref_storage.KeyStorage, ref_storage.SecureLogger)}


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_vault_moves_between_packages(tmp_path, aead, writer, reader):
    path = tmp_path / "vault.json"
    w = PACKAGES[writer][0](path)
    assert w.unlock("first-pass")
    w.store("alpha", {"x": [1, 2]})
    w.store_bytes("blob", bytes(range(256)))
    purpose = w.get_or_create_purpose_key("secure_logger")
    w.save_peer_shared_key("peerA", b"k" * 32, "ML-KEM-768")
    assert w.change_password("first-pass", "second-pass")

    r = PACKAGES[reader][0](path)
    assert not r.unlock("first-pass")
    assert r.unlock("second-pass")
    assert r.retrieve("alpha") == {"x": [1, 2]}
    assert r.retrieve_bytes("blob") == bytes(range(256))
    assert r.get_or_create_purpose_key("secure_logger") == purpose
    (entry,) = r.list_key_history("peerA")
    value = r.get_key_history_value(entry["name"])
    assert base64.b64decode(value["key"]) == b"k" * 32 and value["algorithm"] == "ML-KEM-768"
    # and back: what the reader writes, the writer reads
    r.store("beta", "from the reader")
    assert r.change_password("second-pass", "third-pass")
    w2 = PACKAGES[writer][0](path)
    assert w2.unlock("third-pass")
    assert w2.retrieve("beta") == "from the reader"
    assert {e["name"] for e in w2.list_entries()} >= {"alpha", "blob", "beta", entry["name"]}


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_log_moves_between_packages(tmp_path, aead, writer, reader):
    key = os.urandom(32)
    w = PACKAGES[writer][1](key, tmp_path)
    w.log_event("key_exchange", algorithm="ML-KEM-768", peer="p1")
    w.log_event("message_sent", size=300, algorithm="AES-256-GCM")
    r = PACKAGES[reader][1](key, tmp_path)
    assert [e["event_type"] for e in r.get_events()] == ["key_exchange", "message_sent"]
    r.log_event("message_received", size=12)
    assert w.get_security_metrics()["bytes_received"] == 12
    assert PACKAGES[reader][1](os.urandom(32), tmp_path).get_events() == []


# -- without the wheel ----------------------------------------------------------------

_NO_WHEEL = '''
import json, sys
from pathlib import Path

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "cryptography" or name.startswith("cryptography."):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _Block())
from quantum_resistant_p2p_tpu_torch.provider import get_symmetric, symmetric
from quantum_resistant_p2p_tpu_torch.storage import KeyStorage, KeyStorageError, SecureLogger

out = Path(sys.argv[1])
assert symmetric._aead is None and symmetric.AES256GCM_IMPL == "port (host)"
aes = get_symmetric("AES-256-GCM")
key = aes.generate_key()
assert aes.decrypt(key, aes.encrypt(key, b"scalar", b"ad"), b"ad") == b"scalar"

ks = KeyStorage(out / "vault.json")
assert ks.unlock("pw-one")
assert json.loads((out / "vault.json").read_text())["kdf"]["algo"] == "scrypt"
ks.store("alpha", {"x": 1})
ks.save_peer_shared_key("peerA", b"k" * 32, "ML-KEM-768")
log_key = ks.get_or_create_purpose_key("secure_logger")
assert ks.change_password("pw-one", "pw-two")
again = KeyStorage(out / "vault.json")
assert not again.unlock("pw-one") and again.unlock("pw-two")
assert again.retrieve("alpha") == {"x": 1} and again.list_key_history("peerA")

log = SecureLogger(again.get_or_create_purpose_key("secure_logger"), out / "logs")
assert again.get_or_create_purpose_key("secure_logger") == log_key
log.log_event("key_exchange", algorithm="ML-KEM-768", peer="p1")
log.log_event("message_sent", size=256)
assert [e["event_type"] for e in log.get_events()] == ["key_exchange", "message_sent"]

try:
    KeyStorage(out / "argon2id.json").unlock("pw")
except KeyStorageError as exc:
    assert "cryptography" in str(exc), exc
else:
    raise AssertionError("an Argon2id vault opened without the wheel")
blocked = sorted(m for m in sys.modules if m.split(".")[0] == "cryptography")
print("OK", blocked, log_key.hex())
'''


def test_vault_and_log_round_trip_without_the_wheel(tmp_path):
    # a vault header that asks for Argon2id (its check is never reached)
    (tmp_path / "argon2id.json").write_text(json.dumps({
        "format_version": 1, "salt": base64.b64encode(bytes(16)).decode(),
        "kdf": {"algo": "argon2id", "iterations": 3, "lanes": 4, "memory_cost": 102400},
        "check": {"nonce": base64.b64encode(bytes(12)).decode(),
                  "ct": base64.b64encode(bytes(40)).decode()},
        "entries": {}}))
    out = subprocess.run([sys.executable, "-c", _NO_WHEEL, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "QRP2P_TPU_HOME": str(tmp_path / "home")})
    assert out.returncode == 0, out.stderr[-3000:]
    status, blocked, log_key = out.stdout.split()[-3:]
    assert status == "OK" and blocked == "[]", out.stdout
    # the JAX package, on OpenSSL, reads what the port's own AES-256-GCM sealed
    ref = ref_storage.KeyStorage(tmp_path / "vault.json")
    assert ref.unlock("pw-two")
    assert ref.retrieve("alpha") == {"x": 1}
    assert ref.get_or_create_purpose_key("secure_logger").hex() == log_key
    events = ref_storage.SecureLogger(bytes.fromhex(log_key), tmp_path / "logs").get_events()
    assert [e["event_type"] for e in events] == ["key_exchange", "message_sent"]
