"""A rank of a run on several ranks with a fault planted first::

    python -m benchmark.tests.faulty_rank <fault> <job>

(``ranks.launch(..., entry=[sys.executable, "-m",
"benchmark.tests.faulty_rank", fault])``; the faults are those of
``faults.plant``)."""

import sys

from benchmark import ranks
from benchmark.tests import faults

if __name__ == "__main__":
    faults.plant(sys.argv[1])
    ranks.main()
