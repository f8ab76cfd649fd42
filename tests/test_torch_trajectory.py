"""Whole serve trajectories of the port against the JAX package: committed
checkpoints played through both stacks at the regress settings
(``make_rl_env(game, 2, episodic_life=False, clip_rewards=False)``, env
seeds ``arange(2) + seed``, the key schedule of
``toybox_tpu.regress.play_games``), with JAX's random draws fed to the
port's head at every step: here the ppo regress models of Amidar and
Space Invaders and acktr's K-FAC net on Amidar (sharing the JAX Amidar
env's compile); tests/test_torch_trajectory_heads.py plays the Breakout
heads (acer's pi beside its Q head, deepq's greedy Q with JAX's epsilon
draws, the recurrent carry, the bf16-trained ppo model) through
``check_trajectory``.

The lock-step play, the draws of every head family and the near-tie rule
are those of ``scripts/gate_vs_jax.py`` (imported from there): JAX draws
``key, akey = split(key)`` per step and samples as its eval head does
(``argmax(logits + gumbel(akey))``, or deepq's explore mask and random
action beside the greedy Q); the port takes the same draws. Where the
actions differ, both take JAX's action. Raw rewards and dones must be
equal at every step.

The two pipelines may differ by 1 grey level where a warp sum lands next
to a half-integer (tests/test_torch_pipeline.py), so the two heads see
observations that can differ by 1/255 in a few pixels and their logits by
a little: up to 1.6e-3 over the first 864 agent steps of the full Amidar
gate (10 games, seed 0). A step where the actions differ is then a near
tie: JAX's top two ``logits + g`` (or Q values) lie within NEAR_TIE of
each other and within twice the largest difference of the two heads at
that step (the least difference that can reorder them), and that
difference is below LOGIT_NOISE. Every flip must be such a near tie, and
the first may come no earlier than MIN_COMPARED agent steps: at seed 0
both games of every case follow JAX for all of them, so an early flip,
even within a near tie, means the port changed. The test reports the
first step where a check fails.

Run as a script, it plays a longer comparison and prints where it ends:

    PYTHONPATH=. python tests/test_torch_trajectory.py \
        models/Amidar.regress.model 10 3000

(the checkpoint, the number of games, the most agent steps).
"""

import importlib.util
import sys
from pathlib import Path

import pytest

from tests.test_torch_codecs import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
MODELS = "models"
N_GAMES = 2
NEAR_TIE = 5e-3
LOGIT_NOISE = 1e-2
MIN_COMPARED = 150


def _gate_vs_jax():
    spec = importlib.util.spec_from_file_location(
        "gate_vs_jax", ROOT / "scripts" / "gate_vs_jax.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module       # dataclasses look it up there
    spec.loader.exec_module(module)
    return module


gate = _gate_vs_jax()


def check_trajectory(model: str, steps: int) -> None:
    """Play ``models/<model>`` at the regress settings through both stacks
    in lock-step for ``steps`` agent steps and hold it to the checks above."""
    r = gate.lockstep(gate.regress_cell(f"{ROOT / MODELS / model}", seed=0,
                                        n=N_GAMES, steps=steps))
    first = r.flips[0].step if r.flips else None
    print(f"{model}: {r.steps} agent steps, raw scores {r.totals.tolist()}, "
          f"largest difference {r.worst:.3g}; flips {r.flips}")
    assert r.fault is None, f"{model}: {r.fault}"
    assert r.steps == steps, f"{model}: stopped after {r.steps} steps"
    assert first is None or first >= MIN_COMPARED, (
        f"{model}: the actions went apart at agent step {first} "
        f"({r.flips[0]}), before {MIN_COMPARED} of the {steps} steps")
    for f in r.flips:
        assert f.margin < NEAR_TIE and f.diff < LOGIT_NOISE \
            and gate.near_tie(f.margin, f.diff), (
                f"{model}: actions differ at agent step {f.step} (env "
                f"{f.env}) with a margin of {f.margin:.3g} between the top "
                f"two, largest difference {f.diff:.3g}: not a near tie")


@pytest.mark.parametrize("game,model,steps", [
    ("amidar", "Amidar.regress.model", 200),
    ("space_invaders", "SpaceInvaders.regress.model", 200),
    ("amidar", "Amidar.acktr.model", 160)])
def test_serve_trajectory_follows_jax(game, model, steps):
    check_trajectory(model, steps)


if __name__ == "__main__":
    import time

    path, n_games, n_steps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    t0 = time.perf_counter()
    r = gate.lockstep(gate.regress_cell(path, seed=0, n=n_games,
                                        steps=n_steps))
    print(f"{path}, {n_games} games, seed 0: {r.steps} agent steps, raw "
          f"scores {r.totals.tolist()}, fault {r.fault}; flips {r.flips}; "
          f"{time.perf_counter() - t0:.0f} s")
