"""CPU tests of the benchmark harness (python3 -m pytest port_bench/tests);
the ones marked `cuda` run a cell on the card and skip elsewhere."""
