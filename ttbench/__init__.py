"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

``python3 ttbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` serves one cell of ``BENCHMARK.json`` on the card and
prints one JSON line.  Everything a cell needs is found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and the family modules the configuration names
(``families/<family>.py`` drives the program, ``reference/<family>.py``
is its plain reference).
"""
