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
  ``.prompt(prompt, room)``, ``.readout(node, x)``, ``.decode(tok,
  pos, kv, strategy, tables, depth=None, pick=None)`` and the counts
  ``.ties``, ``.followed`` and ``.capped`` (``reference/check.py``
  judges through it).  ``decode`` returns ``(served node, {node:
  logits}, probed segments)``.  ``pick`` comes only from a
  configuration that states a routing tie band
  (``check.routing_tie``): a family that routes (MoE) then lists, at
  each routing of the token, the expert sets within ``pick.tau`` of its
  own top-k (`ttbench.reference.ties.topk_candidates`), computes the
  token through the remaining layers and segments once a set (a branch:
  its served node, its logits at every probed node, its depth and its
  new KV rows), at most ``pick.max_branches`` branches a token, layer by
  layer and the nearest ties first (past the cap its own choice stands),
  calls ``pick(branches)`` with the ``(served, logits, depth)`` of
  each, its own first, on every token, keeps only the chosen branch's
  KV rows and returns it; it counts ``ties`` (tokens with more than one
  branch), ``followed`` (tokens whose kept branch is not its own) and
  ``capped`` (tokens at which the cap left a set out).  A family that
  routes nothing takes ``pick`` and ignores it, its counts 0;
- ``prompt_flops(m, start, width, last)`` and ``probe_flops(m, probes,
  ctx)``: the useful FLOPs ``metrics/step_mfu.py`` counts.

The harness, the comparison and the metric readers import no family's
reference or counts: they reach them through ``Cell.family``.
"""

CONTRACT = ("shapes", "make_weights", "program_config", "Model",
            "prompt_flops", "probe_flops")
DECODE_KEYWORDS = ("depth", "pick")     # ``Model.decode``'s, None by default
