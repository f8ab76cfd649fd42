"""Full training-state checkpoint and resume (port of
toybox_tpu.utils.checkpoint ``Checkpointer``).

The JAX package writes its whole training pytree with flax; the card
machine has no flax, so the port writes a training state's
``state_dict()`` (parameters, optimizer moments, env state, generator
state, update count) with ``torch.save`` and restores it into a freshly
initialised state with ``load_state_dict``. These files are the port's
own; a policy to share with the JAX package goes through
``rl.ppo.save_params`` instead.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, state) -> None:
    """Write ``state.state_dict()`` to path (atomically, via a rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, state):
    """Restore ``state`` in place from a save_checkpoint file and return
    it. The file holds the env state's dataclasses, so it is unpickled in
    full: load only files this code wrote."""
    state.load_state_dict(torch.load(path, weights_only=False,
                                     map_location="cpu"))
    return state


class Checkpointer:
    """Periodic save and restore-latest for a learn loop.

    ``restore(state)`` loads the newest ``<prefix>_<n>`` into the freshly
    initialised state if one exists; ``maybe_save(state, n)`` writes
    ``<prefix>_<n>`` every ``freq`` calls. Does nothing when ``ckpt_dir``
    is None, so learn loops can call it unconditionally."""

    def __init__(self, ckpt_dir, freq: int = 50, prefix: str = "ckpt"):
        self.ckpt_dir = ckpt_dir
        self.freq = max(int(freq), 1)
        self.prefix = prefix

    def restore(self, state):
        if self.ckpt_dir is None:
            return state
        path = latest_checkpoint(self.ckpt_dir, self.prefix)
        if path is None:
            return state
        return load_checkpoint(path, state)

    def maybe_save(self, state, n: int) -> None:
        if self.ckpt_dir is not None and n % self.freq == 0:
            save_checkpoint(
                os.path.join(self.ckpt_dir, f"{self.prefix}_{n}"), state)


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt"):
    """The '<prefix>_<step>' file with the highest step in a directory, or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(ckpt_dir):
        if not name.startswith(prefix + "_"):
            continue
        try:
            step = int(name.rsplit("_", 1)[1].split(".")[0])
        except ValueError:
            continue
        if step > best_step:
            best, best_step = os.path.join(ckpt_dir, name), step
    return best
