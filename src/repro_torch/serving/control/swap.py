"""`BankSwap` — atomic strategy-bank exchange between token steps.

Steppers run their decision program over a fixed-size tuple of
strategies, route per lane with a stamped ``sid``, and read every
slot's DYNAMIC ARRAYS (`strategy.dynamic_arrays`) from their
``bank_source`` at each step.  That turns both control actions into
host-side moves that never rebuild the step:

  * **gear switch** — ``swap_to(slot)`` changes which slot NEW
    admissions are stamped with (`sid_of`); in-flight lanes keep their
    admitted ``sid`` and finish on the gear that admitted them, so a
    switch never drops or restyles a live stream;
  * **table publish** — ``publish(slot, strategy)`` checks that the
    newcomer carries the slot's reserved `slot_signature` (class, and
    the name, shape and dtype of every tensor), then ``copy_``s its
    dynamic arrays INTO the slot's reserved tensors.  The step reads
    the same storages across every swap and publish — the decisions
    are those of the JAX package's pointer exchange, and nothing the
    step holds is ever replaced.

The reserved tensors are this object's own copies (a publish never
writes into a strategy's tensors) and live on the stepper's device
(`to`, called by the controller before the serve starts).  Both actions
land between token steps only: the `Server` consults this object via
the stepper's ``bank_source`` at the top of each step, and the
`AdaptiveController` mutates it in ``on_step_end``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.strategy.base import array_leaves, dynamic_arrays
from repro_torch.strategy.registry import reserve_bank, slot_signature

__all__ = ["BankSwap"]


def _reserve(arrays: dict, device) -> dict:
    """Fresh copies of ``arrays`` on ``device`` (the slot's storages)."""
    def copy(t):
        return t.detach().to(device, copy=True)

    return {name: copy(v) if isinstance(v, torch.Tensor)
            else dataclasses.replace(v, **{
                f.name: copy(getattr(v, f.name))
                for f in dataclasses.fields(v)})
            for name, v in arrays.items()}


class BankSwap:
    """Mutable strategy bank with signature-guarded in-place publishes."""

    def __init__(self, strategies, *, start: int = 0):
        members, self.signatures = reserve_bank(strategies)
        self.strategies = list(members)
        arrays = [dynamic_arrays(s) for s in self.strategies]
        leaves = [t for a in arrays for t in array_leaves(a)]
        # the reserved copies start where the strategies' tensors are
        self.device = leaves[0].device if leaves else torch.device("cpu")
        self._arrays = tuple(_reserve(a, self.device) for a in arrays)
        if not 0 <= start < len(self.strategies):
            raise ValueError(f"start slot {start} outside bank of "
                             f"{len(self.strategies)}")
        self.gear = int(start)
        self.switches: list[tuple[float, int, int]] = []   # (t, old, new)
        self.publishes: list[tuple[float, int]] = []       # (t, slot)

    def __len__(self) -> int:
        return len(self.strategies)

    def to(self, device) -> None:
        """Move the reserved storages to ``device`` — done once, before a
        serve starts; a no-op when they are there already."""
        device = torch.device(device)
        if device != self.device:
            self._arrays = tuple(_reserve(a, device) for a in self._arrays)
            self.device = device

    # ---- what the stepper reads each step ----------------------------

    def bank_arrays(self) -> tuple:
        """Per-slot dynamic arrays for the next token step: the reserved
        storages, the same tensors at every step."""
        return self._arrays

    def sid_of(self, req) -> int:
        """Admission stamp: every request admitted from now decides on
        the ACTIVE gear's slot.  The request keeps this sid for life."""
        return self.gear

    # ---- what the controller writes between steps --------------------

    def swap_to(self, slot: int, now: float) -> bool:
        """Point new admissions at ``slot``; returns True on a change."""
        slot = int(slot)
        if not 0 <= slot < len(self.strategies):
            raise ValueError(f"slot {slot} outside bank of "
                             f"{len(self.strategies)}")
        if slot == self.gear:
            return False
        self.switches.append((float(now), self.gear, slot))
        self.gear = slot
        return True

    def publish(self, slot: int, strategy, now: float) -> None:
        """Install a re-calibrated strategy into ``slot``.

        The newcomer must carry the slot's exact swap signature (class,
        tensor names, shapes, dtypes); its arrays are then copied into
        the slot's reserved tensors.  A violating publish raises and
        leaves the bank untouched.
        """
        slot = int(slot)
        sig = slot_signature(strategy)
        if sig != self.signatures[slot]:
            raise ValueError(
                f"publish into slot {slot} changes the swap signature "
                f"(reserved {self.signatures[slot]!r}, got {sig!r}); "
                "recalibrated tables must keep structure/shapes/dtypes")
        with torch.no_grad():
            for dst, src in zip(array_leaves(self._arrays[slot]),
                                array_leaves(dynamic_arrays(strategy))):
                dst.copy_(src)
        self.strategies[slot] = strategy
        self.publishes.append((float(now), slot))
