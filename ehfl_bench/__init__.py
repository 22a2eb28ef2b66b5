"""The benchmark of ``repro_torch``: cells of the EHFL simulator on one card
(``python3 -m ehfl_bench.run``; see README.md)."""
