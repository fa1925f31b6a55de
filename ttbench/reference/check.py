"""The comparison that decides ``correct``.

For each sampled request the reference runs its prompt as the serve
feeds it, then replays the served tokens one by one, walking the
segments as its own tables decide.  At every judged position it reads
one number, the served logit gap: the widest of

- how far the served token's logit lies below the reference's best, at
  the node the reference serves (the first token, the head's choice
  after the prompt, is judged by this alone);
- how far the served logits lie from the reference's at that node, on
  ``cols`` (vocabulary entries drawn from the run's seed) and at the
  served token.

``Model`` is the configuration family's plain reference (its family
module's ``Model``, `ttbench.families`); this module imports none.

The program's side is what its timed path produced: its tokens, and the
rows of the served node's logits the harness read back from the step.
With ``control=True`` the reference computed on TF32-rounded operands
takes the program's place at the same positions, fed the same prompts
and tokens: its first choice and its logits at the node the reference
serves are judged by the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from ttbench.reference.tables import calibrate

__all__ = ["tables_of", "served_gap"]


def _f32_only() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tables_of(Model, m, params, calib_tokens: np.ndarray, lam: float,
              k: int, block: int = 32):
    """The reference's own calibration: node losses of the calibration
    prompts, in blocks of ``block`` prompts, then the tables."""
    _f32_only()
    model = Model(m, params, chunk=1)
    dev = model.device
    out = []
    with torch.no_grad():
        for i in range(0, len(calib_tokens), block):
            toks = torch.as_tensor(calib_tokens[i:i + block], device=dev)
            out.append(model.node_losses(toks).cpu().numpy())
    return calibrate(np.concatenate(out), lam, k)


def served_gap(Model, m, params, chunk: int, tables, sample, cols,
               control: bool = False) -> dict:
    """The widest served logit gap over ``sample``.  Each entry has
    ``prompt`` (int ids), ``first`` (the first token, fed but not
    emitted), ``tokens`` (the emitted tokens), ``strategy``, and for
    the program ``rows`` ((tokens, len(cols)) served logits on
    ``cols``), ``top`` (each served row's largest logit) and ``nodes``
    (the served nodes)."""
    _f32_only()
    ref = Model(m, params, chunk)
    ctl = Model(m, params, chunk, control=True) if control else None
    dev = ref.device
    cols_t = torch.as_tensor(np.asarray(cols), device=dev).long()
    worst, n, nodes, other_node = 0.0, 0, [], 0
    with torch.no_grad():
        for req in sample:
            prompt = torch.as_tensor(np.asarray(req["prompt"]), device=dev)
            toks = [int(t) for t in req["tokens"]]
            x, kv = ref.prompt(prompt, room=len(toks))
            head = ref.readout(m.n_nodes - 1, x[-1])
            if control:
                xc, kvc = ctl.prompt(prompt, room=len(toks))
                first = int(ctl.readout(m.n_nodes - 1, xc[-1]).argmax())
            else:
                first = int(req["first"])
                rows = torch.as_tensor(np.asarray(req["rows"]), device=dev)
                tops = torch.as_tensor(np.asarray(req["top"]), device=dev)
            worst = max(worst, float(head.max() - head[first]))
            n += 1
            feed = [int(req["first"])] + toks[:-1]
            lp = prompt.shape[0]
            for i, inp in enumerate(feed):
                served, logits, depth = ref.decode(inp, lp + i, kv,
                                                   req["strategy"], tables)
                want = logits[served]
                if control:
                    _, lc, _ = ctl.decode(inp, lp + i, kvc, req["strategy"],
                                          tables, depth=depth)
                    tok = int(lc[served].argmax())
                    row, top = lc[served][cols_t], lc[served].max()
                else:
                    tok, row, top = toks[i], rows[i], tops[i]
                    other_node += int(req["nodes"][i]) != served
                gap = torch.stack([want.max() - want[tok],
                                   (top - want[tok]).abs(),
                                   (row - want[cols_t]).abs().max()])
                worst = max(worst, float(gap.max()))
                nodes.append(served)
                n += 1
    return {"served_gap": worst, "tokens": n, "other_node": other_node,
            "nodes": np.bincount(nodes, minlength=m.n_nodes).tolist()}
