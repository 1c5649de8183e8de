"""Full-state checkpointing with ``torch.save``.

Port of ``opendog_tpu/utils/checkpoint.py`` (Orbax there).  The reference
saves model weights only (``torch.save(agent.state_dict())`` every 100
episodes, sim2real/train.py:587-589), so a fresh process cannot resume a
run exactly.  This module saves the whole train state -- parameters,
optimizer state, batched env states, generator states, counters -- so
that training resumes bit for bit.

Layout: ``<directory>/<step>/state.pt``, one file per step, written to a
temporary name and renamed; the oldest steps beyond ``max_to_keep`` are
deleted after each save.  Orbax checkpoints of the JAX package are not
read here.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch

FILE = "state.pt"


def _as_saved(state: Any) -> Any:
    return state.state_dict() if hasattr(state, "state_dict") else state


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, FILE)))

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Saves ``state`` (an object with ``state_dict()``, or a tree of
        tensors, dicts, lists and numbers) at ``step``.  A step already on
        disk is skipped (a final forced save may coincide with a periodic
        one): returns False.  ``force`` is the JAX signature's; every
        save here is written."""
        del force
        if step in self.all_steps():
            return False
        path = os.path.join(self.directory, str(int(step)))
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, FILE + ".tmp")
        torch.save(_as_saved(state), tmp)
        os.replace(tmp, os.path.join(path, FILE))
        steps = self.all_steps()
        for old in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, step: Optional[int] = None, template: Any = None,
                map_location=None) -> Any:
        """The state saved at ``step`` (the latest when None), or None when
        there is none.  With a ``template`` that has ``load_state_dict``
        the saved state is loaded into it in place and the template
        returned; tensors come to ``map_location`` (the CPU by default)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        saved = torch.load(os.path.join(self.directory, str(int(step)), FILE),
                           map_location=map_location or "cpu",
                           weights_only=True)
        if template is not None and hasattr(template, "load_state_dict"):
            template.load_state_dict(saved)
            return template
        return saved

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self):
        """Nothing to release: every save is written when it returns."""
