"""`python -m foundationdb_tpu_torch.tools.lint` — run the port's checkers."""
import sys

from . import CHECKERS
from .core import main

if __name__ == "__main__":
    sys.exit(main(CHECKERS))
