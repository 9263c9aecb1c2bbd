"""Persistent node identity.

Counterpart of the JAX package's ``net/identity.py`` (stdlib but for the
vault it is given), with the same vault entry and file, so a vault or data
directory moves between the packages with its node id.

Parity with the reference's networking/node_identity.py:15-113: a stable
UUID4 node ID, stored encrypted in the KeyStorage vault when one is supplied,
with a plaintext-file fallback that is migrated into the vault (and deleted)
on the next unlock.
"""

from __future__ import annotations

import logging
import uuid
from pathlib import Path

logger = logging.getLogger(__name__)

_ENTRY = "system_node_id"


def load_or_generate_node_id(key_storage=None, data_dir: Path | None = None) -> str:
    """Return the persistent node id, creating one on first run.

    Preference order: vault entry -> plaintext file (migrated to the vault
    and removed) -> freshly generated UUID4.
    """
    from ..storage.key_storage import get_app_data_dir

    data_dir = data_dir or get_app_data_dir()
    plain_path = data_dir / "node_id.txt"

    if key_storage is not None and getattr(key_storage, "is_unlocked", False):
        node_id = key_storage.retrieve(_ENTRY)
        if node_id:
            return node_id
        if plain_path.exists():
            node_id = plain_path.read_text().strip()
            key_storage.store(_ENTRY, node_id)
            plain_path.unlink()
            logger.info("migrated plaintext node id into the vault")
            return node_id
        node_id = str(uuid.uuid4())
        key_storage.store(_ENTRY, node_id)
        return node_id

    if plain_path.exists():
        return plain_path.read_text().strip()
    node_id = str(uuid.uuid4())
    plain_path.parent.mkdir(parents=True, exist_ok=True)
    plain_path.write_text(node_id)
    plain_path.chmod(0o600)
    return node_id
