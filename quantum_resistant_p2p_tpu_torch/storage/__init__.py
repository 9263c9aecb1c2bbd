"""Host-side persistence: atomic/locked files, encrypted key vault, audit log.

Counterpart of the JAX package's ``storage/``, in the same vault and log
formats.  Everything here runs on the host; AES-256-GCM is OpenSSL's where
the ``cryptography`` wheel is installed and the port's ``core.aesgcm``
otherwise (``provider.symmetric.aes256gcm``).
"""

from .secure_file import AtomicFile, FileLock
from .key_storage import KeyStorage, KeyStorageError
from .secure_logger import SecureLogger

__all__ = [
    "AtomicFile",
    "FileLock",
    "KeyStorage",
    "KeyStorageError",
    "SecureLogger",
]
