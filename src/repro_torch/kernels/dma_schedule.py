"""Slot arithmetic of the two-slot copy2Fast ring.

The paper's ``copy2Fast`` overlap, start copying streamed element j+1 while
element j multiplies, is one schedule over a ``[N_SLOTS, ...]`` buffer:

  * step ``lin == 0`` primes the pipeline: element 0 is copied into slot 0
    and waited on before use;
  * every step with a successor starts the copy of element ``lin + 1`` into
    slot ``(lin + 1) % 2``, the *other* slot;
  * every step waits on and reads element ``lin`` from slot ``lin % 2``.

On the card the slots are device buffers and the copies cross from pinned
host memory on a side stream (``repro_torch.core.copy_ring``). This module
is the single source of that arithmetic: the ring calls these functions
with its step indices, and the checkers (``repro_torch.analysis.dma`` and
``repro_torch.analysis.interleave``) call them to replay the whole stream
and prove it race-free. One definition, so the ring and the checkers
cannot drift apart.
"""

from __future__ import annotations

N_SLOTS = 2


class SlotSchedule:
    """The two-slot schedule as an object, so a checker can be handed a
    deliberately broken schedule without touching the real one."""

    n_slots = N_SLOTS

    def __init__(self):
        # with fewer than two slots the prefetch of element lin+1 targets
        # the slot step lin reads: every such schedule is a race
        if self.n_slots < 2:
            raise ValueError(
                f"SlotSchedule needs n_slots >= 2 (got {self.n_slots}): a "
                "single slot cannot overlap copy with compute")

    def read_slot(self, lin):
        """Slot holding streamed element ``lin`` when step ``lin`` runs."""
        return lin % self.n_slots

    def prefetch_slot(self, lin):
        """Slot the step-``lin`` prefetch of element ``lin + 1`` targets."""
        return (lin + 1) % self.n_slots

    def is_prime_step(self, lin):
        """Whether step ``lin`` must stage its own element (only the first
        step has no predecessor to prefetch it)."""
        return lin == 0

    def prime_slot(self):
        """Slot the warm-up copy of element 0 targets (== read_slot(0))."""
        return 0

    def has_prefetch(self, lin, total):
        """Whether step ``lin`` starts the copy of element ``lin + 1``."""
        return lin + 1 < total


TWO_SLOT = SlotSchedule()

# module-level aliases, keeping call sites terse
read_slot = TWO_SLOT.read_slot
prefetch_slot = TWO_SLOT.prefetch_slot
is_prime_step = TWO_SLOT.is_prime_step
prime_slot = TWO_SLOT.prime_slot
has_prefetch = TWO_SLOT.has_prefetch
