"""The benchmark of ``abstracts_search_tpu_torch`` on NVIDIA H100 cards.

One command runs one cell (a configuration under a traffic mix) once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells, configurations
and metrics. Everything of one configuration, traffic mix or metric sits
in a file of its own that the harness finds by name:

- ``configs/<config>.json``: the deployment's sizes, as run;
- ``traffic/<workload>.json``: the mix's parameters and the driver
  (``drivers/<driver>.py``) that runs it;
- ``metrics/<metric>.py``: one reader each, ``read(run) -> float | None``.

The yardstick lives here too and nowhere in the program: the inputs made
from the seed (``yardstick/corpus.py``), the peaks and the operation and
byte counts (``yardstick/peaks.py``), the reduction of a device trace
(``yardstick/timeline.py``) and the plain references that decide
``correct`` (``reference/``).
"""
