"""Secret-name vocabulary: the names whose values never reach a log, a
trace or a flight dump.

``obs/flight.py`` redacts secret-named fields at record time with these
patterns.  Counterpart of the reference's ``obs/redaction.py``, with the
same patterns, so a field redacted there is redacted here.  Stdlib only.
"""

from __future__ import annotations

import re

#: identifiers that hold secret material.  ``_key`` suffixes are secret by
#: default (entry_key, index_key, log_key, shared_key, ...); the NONSECRET
#: list walks back the public/verification-side names.
SECRET_NAME_RE = re.compile(
    r"(password|passwd|secret|private|master|keypair)"
    r"|(^|_)stek($|_)"
    r"|(^|_)(sk|skey)($|_)"
    r"|(^|_)key$"
    r"|^key$",
    re.IGNORECASE,
)
NONSECRET_NAME_RE = re.compile(r"(public|pub($|_)|(^|_)pk($|_)|verify|test)", re.IGNORECASE)


def is_secret_name(name: str | None) -> bool:
    if not name:
        return False
    return bool(SECRET_NAME_RE.search(name)) and not NONSECRET_NAME_RE.search(name)
