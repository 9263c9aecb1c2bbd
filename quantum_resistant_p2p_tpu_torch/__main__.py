"""Entry point: ``python -m quantum_resistant_p2p_tpu_torch`` (the
``qrp2p-torch`` console script), which runs ``cli.main()``; counterpart of
the JAX package's ``__main__.py``.
"""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
