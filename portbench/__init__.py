"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on NVIDIA
H100 cards.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything the harness needs to know of a cell is found by name: the
configuration in ``configs/<config>.json`` (the source's numbers, as
run, the port's config they are held to and the dtypes it runs in), the
traffic mix in ``traffic/<mix>.json`` (parameters read by the general driver of
its ``kind`` in ``drivers/``), each per-layer metric in
``metrics/<metric>.py`` and each cell's limits of ``correct`` in
``limits/<workload>.json``. The yardstick (peaks, operation and byte
counts, kernel groups, the plain reference and the comparison) lives
here too, so that a later change to the port cannot move it.
"""
