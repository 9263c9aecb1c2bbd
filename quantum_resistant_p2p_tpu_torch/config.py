"""Configuration — provider selection, batching, the listening port.

Counterpart of the JAX package's ``config.py``: the same file
(``config.json`` in the data directory, ``QRP2P_TPU_HOME``), the same
``QRP2P_*`` environment variables and the same precedence, feeding the CLI.
The port keeps only the keys something reads: ``UNREAD_KEYS`` are the JAX
package's other keys, which nothing there reads either; a file or a
``QRP2P_*`` variable that sets one is warned about, not obeyed.
``backend`` is ``"cuda"`` (the default) or ``"cpu"``; any other value
raises.  ``mesh_devices`` > 0 reaches the engine, which raises: splitting
one batch across GPUs is not ported.

Precedence: explicit kwargs > environment > config file > defaults.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path

logger = logging.getLogger(__name__)

#: the provider backends: the GPU, or the plain versions on the CPU
BACKENDS = ("cuda", "cpu")
#: the JAX package's config keys that nothing reads (algorithms are chosen
#: with the CLI's /set; the batch queues, discovery and chunking keep their
#: own defaults)
UNREAD_KEYS = ("kem", "aead", "signature", "max_batch", "max_wait_ms",
               "discovery_port", "chunk_size")


@dataclasses.dataclass
class Config:
    # provider
    backend: str = "cuda"  # cuda | cpu
    use_batching: bool = False
    # networking (reference default: networking/p2p_node.py:20)
    port: int = 8000
    # multi-device: device batches split across this many GPUs
    # (0 = one device; the engine raises on more until that is ported)
    mesh_devices: int = 0

    @classmethod
    def default_path(cls) -> Path:
        from .storage.key_storage import get_app_data_dir

        return get_app_data_dir() / "config.json"

    @classmethod
    def load(cls, path: str | os.PathLike | None = None, **overrides) -> "Config":
        cfg = cls()
        p = Path(path) if path else cls.default_path()
        if p.exists():
            try:
                data = json.loads(p.read_text())
                for k, v in data.items():
                    if hasattr(cfg, k):
                        setattr(cfg, k, v)
                    else:
                        logger.warning("unknown config key %r in %s", k, p)
            except ValueError as e:
                logger.warning("malformed config %s: %s (using defaults)", p, e)
        for k in UNREAD_KEYS:
            if f"QRP2P_{k.upper()}" in os.environ:
                logger.warning("QRP2P_%s is not read here", k.upper())
        for f in dataclasses.fields(cls):
            env = os.environ.get(f"QRP2P_{f.name.upper()}")
            if env is not None:
                try:
                    if f.type == "bool":
                        setattr(cfg, f.name, env.lower() in ("1", "true", "yes", "on"))
                    else:
                        setattr(cfg, f.name, type(getattr(cfg, f.name))(env))
                except ValueError:
                    logger.warning("bad env value QRP2P_%s=%r", f.name.upper(), env)
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise TypeError(f"no config key {k!r}")
            if v is not None:
                setattr(cfg, k, v)
        if cfg.backend not in BACKENDS:
            raise ValueError(f"backend {cfg.backend!r}: one of {', '.join(BACKENDS)}")
        return cfg

    def save(self, path: str | os.PathLike | None = None) -> Path:
        p = Path(path) if path else self.default_path()
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(dataclasses.asdict(self), indent=2))
        return p
