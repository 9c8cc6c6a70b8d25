"""``python -m mh_spgemm_torch <matrix>`` — the benchmark CLI
(``bench/driver.py``)."""

import sys

from .bench.driver import main

if __name__ == "__main__":
    sys.exit(main())
