"""How the harness drives the program, and judges and counts it, for each
family of configuration files (``"family"`` in the file names the module
``families/<family>.py``, found by file).

A family module is the whole contract of its configurations; it exports:

- ``shapes(cfg)``: the configuration file's numbers as the benchmark's
  shapes (``m``; ``m.vocab`` and ``m.n_nodes`` at least);
- ``make_weights(m, seed, device)``: the benchmark's weights from the
  seed, in the program's parameter layout;
- ``program_config(cfg)``: the program's ``ModelConfig``;
- ``Model``: the plain reference, ``Model(m, params, chunk,
  control=False)`` with ``.device``, ``.node_losses(tokens)``,
  ``.prompt(prompt, room)``, ``.readout(node, x)`` and ``.decode(tok,
  pos, kv, strategy, tables, depth=None)`` (``reference/check.py``
  judges through it);
- ``prompt_flops(m, start, width, last)`` and ``probe_flops(m, probes,
  ctx)``: the useful FLOPs ``metrics/step_mfu.py`` counts.

The harness, the comparison and the metric readers import no family's
reference or counts: they reach them through ``Cell.family``.
"""

CONTRACT = ("shapes", "make_weights", "program_config", "Model",
            "prompt_flops", "probe_flops")
