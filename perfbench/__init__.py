"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on H100 cards.

``BENCHMARK.json`` at the repository's root lists the cells. A run is

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything that belongs to one configuration,
one traffic mix or one metric sits in a file of its own, found by the name
that ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the deployment (its public source, the
  generator's parameters, the elastic range, the guarantees, the limits of
  the comparison that decides ``correct``);
* ``mixes/<traffic>.json``: a traffic mix's parameters and the name of the
  driver in ``drivers/`` that plays it;
* ``metrics/<metric>.py``: one reader a metric, ``read(run) -> float | None``;
* ``generators/<module>.py``: makes a configuration's input from the seed;
* ``systems/<name>.py``: a system under test that a configuration names
  with ``"system"`` (``sharded``: the port's layout over ranks); one that
  names none runs ``sut.py``'s, the port on one card.

A cell with ``chips`` above 1 runs one process a card (``ranks.py``).

The yardstick (the generator, the frozen CEP arithmetic in ``cep.py``, the
plain reference in ``reference.py``, the byte formulas and peaks in
``peaks.py``, the reading of the device trace in ``devtrace.py``) imports
nothing of the port. ``sut.py`` and the modules of ``systems/`` are the
only ones that do: they hold the systems under test.
"""
