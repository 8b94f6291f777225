"""The benchmark of the PyTorch port (``hopvae_torch``) on an H100.

One run of one cell: ``python3 hopbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` from the repository's root. The cells,
configurations and metrics are named in ``BENCHMARK.json``; each is a file
here (:mod:`hopbench.harness`). The control's and an altered answer's readings:
``python3 hopbench/control.py``. CPU tests: ``python -m pytest
hopbench/tests``; the card's: the same with ``-m cuda`` on the card.
"""
