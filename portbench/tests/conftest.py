"""The portbench tests import the benchmark as the package ``portbench``
from the root of the checkout. Run them from there:

    python -m pytest portbench/tests -q

The tests marked ``cuda`` run a cell on a CUDA card and skip without one.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
