"""``python -m heracles_tpu_torch``: the port's command line (:mod:`.cli`)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
