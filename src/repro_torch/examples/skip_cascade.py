"""Inter-model cascade with SKIPS (§5.2; the JAX package's
``examples/skip_cascade.py``): three decoders of increasing size form
the transitive closure of a line — the `skip_recall` strategy may jump
straight from the small model to the large one, skipping the middle,
based on the calibrated Markov structure of their losses.  The same
registry strategy object evaluates offline here and plugs into the
serving engine unchanged.  On the card each model's prefill runs its
attention through the flash-attention kernel.

  PYTHONPATH=src python -m repro_torch.examples.skip_cascade --device cpu
  PYTHONPATH=src python -m repro_torch.examples.skip_cascade   # the card
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import strategy
from repro_torch.configs.common import dense_decoder
from repro_torch.core import skip_dp
from repro_torch.core.support import quantize
from repro_torch.launch.serve import device_of
from repro_torch.models import model as M
from repro_torch.models.param import count_params, materialize

T, SEQ, VOCAB = 2_000, 24, 512     # the shared query stream
LAM = 0.75
TOKEN_SEED, SHAPE_SEED = 1, 0      # numpy seeds: queries, shaping


def make_family():
    """Small / medium / large single-exit decoders."""
    sizes = [(2, 96), (2, 192), (4, 256)]
    return [dense_decoder(f"cascade-{i}", n_layers=layers, d_model=d,
                          n_heads=4, n_kv_heads=4, head_dim=d // 4,
                          d_ff=2 * d, vocab=VOCAB, n_segments=1, act="gelu")
            for i, (layers, d) in enumerate(sizes)]


def init_models(cfgs, device):
    """Random-init weights of each config from seed 0."""
    return [materialize(M.model_defs(c),
                        torch.Generator(device=device).manual_seed(0),
                        device) for c in cfgs]


def model_losses(cfgs, params_list, toks, *, use_flash: bool):
    """(T, n_models) final-node losses of each model's prefill of the
    (T, seq) queries ``toks`` (the final node is the loss proxy)."""
    out = []
    with torch.no_grad():
        for cfg, params in zip(cfgs, params_list):
            dev = params["embed"]["table"].device
            _, _, node_losses, _ = M.prefill(
                params, cfg, {"tokens": torch.as_tensor(toks, device=dev)},
                toks.shape[1] + 8, use_flash=use_flash)
            out.append(node_losses[:, -1].cpu().numpy())
    return np.stack(out, axis=1)


def shape_losses(losses, rng):
    """Random-init models are equally (un)confident, which collapses the
    cascade; emulate trained checkpoints by shaping: each model solves
    queries up to its capacity, larger models extend the range.  The
    unsolved loss grows with hardness, so the small model's loss reveals
    how hard the query is — the signal that makes jumping straight to
    the large model optimal for the hardest band."""
    hardness = rng.uniform(0, 1, size=(losses.shape[0], 1))
    capacity = np.array([[0.35, 0.65, 0.95]])
    solved = hardness <= capacity
    losses = np.where(solved, 0.05 * losses + 0.02,
                      0.25 + 0.65 * hardness + 0.05 * losses) \
        + rng.normal(0, 0.01, losses.shape)
    return np.clip(losses, 1e-3, 1.0)


def relative_costs(cfgs):
    """Costs proportional to model size, summing to one."""
    rel = np.array([count_params(M.model_defs(c)) for c in cfgs],
                   np.float64)
    return rel / rel.sum()


def fit_and_evaluate(losses, rel, device, *, lam=LAM):
    """Fit on the first half, solve the skip tables (skip-free and
    strict-line), evaluate `skip_recall` on the second half and walk
    the numpy reference over it.  Returns the numbers the example
    prints and the pieces a caller checks."""
    t = losses.shape[0]
    fit, ev = losses[:t // 2], losses[t // 2:]
    casc = strategy.Cascade.from_traces(fit, (1 - lam) * rel, k=24,
                                        lam=lam, solve=False, device=device)
    tables = casc.solve_skip(mode="skip_free")
    strat = strategy.make("skip_recall", casc, mode="skip_free", lam=1.0)
    scaled_ev = torch.as_tensor(lam * ev, dtype=torch.float32,
                                device=device)
    res = strategy.evaluate(strat, scaled_ev)
    served = res.served_loss.cpu().numpy()
    spent = res.explore_cost.cpu().numpy()
    # cross-check the streaming strategy against the numpy reference walk
    bins = quantize(casc.support, scaled_ev).cpu().numpy()
    ref_served, ref_spent, probed = skip_dp.simulate_skip(
        tables, scaled_ev.cpu().numpy(), bins, casc.edge_costs)
    if not (np.allclose(served, ref_served, atol=1e-5)
            and np.allclose(spent, ref_spent, atol=1e-5)):
        raise AssertionError("strategy != walk")
    skip_value = float(tables.value)
    line_value = float(casc.solve_skip(mode="cumulative").value)
    hist = probed.mean(0)
    return {"skip_value": skip_value,
            "objective": float((served + spent).mean()),
            "mean_probed": float(res.n_probed.float().mean()),
            "probe_rates": [float(h) for h in hist],
            "skip_fraction": float((probed[:, 0] & ~probed[:, 1]
                                    & probed[:, 2]).mean()),
            "line_value": line_value,
            "casc": casc, "skip_tables": tables, "result": res,
            "probed": probed}


def main(argv=None, *, kernels: bool = True) -> dict:
    """Print the reference's lines; return every number printed (and
    the fitted cascade, its tables and the evaluation).
    ``kernels=False`` runs the prefills' attention in plain PyTorch (the
    card's check of the kernel route)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    device = device_of(ap.parse_args(argv).device)

    cfgs = make_family()
    params_list = init_models(cfgs, device)
    sizes = {}
    for cfg in cfgs:
        sizes[cfg.name] = count_params(M.model_defs(cfg))
        print(f"{cfg.name}: {sizes[cfg.name] / 1e6:.2f}M params")

    # 1. Collect per-model loss traces on a shared query stream.
    toks = np.random.default_rng(TOKEN_SEED).integers(0, VOCAB, (T, SEQ))
    raw = model_losses(cfgs, params_list, toks, use_flash=kernels)
    losses = shape_losses(raw, np.random.default_rng(SHAPE_SEED))

    # 2. Costs proportional to model size; skipping the middle model
    #    avoids its cost entirely (mode="skip_free").
    out = fit_and_evaluate(losses, relative_costs(cfgs), device)
    print(f"\nskip-cascade online-optimal objective: "
          f"{out['skip_value']:.4f}")
    print(f"strategy on eval traces: objective {out['objective']:.4f}, "
          f"mean models probed {out['mean_probed']:.2f}")
    small, medium, large = out["probe_rates"]
    print(f"probe rates per model: small {small:.2f} medium {medium:.2f} "
          f"large {large:.2f}")
    print(f"fraction skipping straight small->large: "
          f"{out['skip_fraction']:.2f}")
    # strict-line comparison (no skips): cumulative edge costs
    print(f"strict-line objective (no skip benefit): "
          f"{out['line_value']:.4f}")
    out.update(param_counts=sizes, raw_losses=raw)
    return out


if __name__ == "__main__":
    main()
