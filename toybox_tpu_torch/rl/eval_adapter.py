"""Load a trained checkpoint into its eval head, and play it on one
interactive env: ``action_fn(tb) -> ale_action`` (port of
toybox_tpu.rl.eval_adapter).

The interactive harnesses drive ONE ``Toybox`` handle frame by frame,
while the trained checkpoints expect the DeepMind observation stack the
batched pipeline produces (skip-4 with the max of the last two frames,
the 84x84 warp, a 4-frame stack; ``envs/pipeline.py``). This adapter
rebuilds that stack frame by frame, with the pipeline's frame protocol:
the policy picks a new action on frames 0 mod 4 from the current stack
and repeats it for the next three frames; the frames rendered after
engine frames 3 and 4 of each macro step are the two the max sees.
Frames come from the game's single-frame kernel (the pipeline's reset
renderer: on a CPU tensor its plain version, ``luma2d(render)``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from toybox_tpu_torch.core.actions import LEGAL_ACTIONS
from toybox_tpu_torch.envs.pipeline import _RENDERERS
from toybox_tpu_torch.games import get_game
from toybox_tpu_torch.ops import obs as obs_ops
from toybox_tpu_torch.rl.checkpoint import load_state_dict
from toybox_tpu_torch.rl.models import RECURRENT_NETWORKS
from toybox_tpu_torch.rl.policies import build_eval_head

#: checkpoint suffix (models/<Game>.<suffix>.model) -> (alg, network) of
#: the eval head that loads it
CHECKPOINT_HEADS = {
    "regress": ("ppo", "cnn"), "ppo_bf16": ("ppo", "cnn"),
    "ppo1": ("ppo1", "cnn"), "a2c": ("a2c", "cnn"),
    "a2c_bf16": ("a2c", "cnn"), "gail": ("gail", "cnn"),
    "bc": ("gail", "cnn"), "trpo": ("trpo", "cnn_small"),
    "acer": ("acer", "cnn_small"), "acktr": ("acktr", "cnn"),
    "deepq": ("deepq", "conv_only"), "ppo_lstm": ("ppo", "cnn_lstm"),
    "a2c_lstm": ("a2c", "cnn_lstm"), "ppo_lnlstm": ("ppo", "cnn_lnlstm"),
    "acer_lstm": ("acer", "cnn_lstm"),
}


def checkpoint_head(path) -> tuple:
    """(alg, network) of a models/<Game>.<suffix>.model file."""
    name = os.path.basename(str(path))
    suffix = name.split(".")[1] if name.count(".") >= 2 else ""
    if suffix not in CHECKPOINT_HEADS:
        raise ValueError(f"no eval head known for {name!r}; suffixes "
                         f"{sorted(CHECKPOINT_HEADS)}")
    return CHECKPOINT_HEADS[suffix]


def eval_head(alg: str, network: str, game: str, frame_size: int = 84,
              frame_stack: int = 4, nlstm: int = 128, seed: int = 0,
              device="cuda"):
    """(module, step_fn) of ``alg``'s eval head for ``game``'s actions;
    recurrent networks get the carry-threading head."""
    return build_eval_head(alg, (frame_size, frame_size, frame_stack),
                           len(LEGAL_ACTIONS[game]), network, nlstm=nlstm,
                           seed=seed, device=device)


def load_eval_params(alg: str, network: str, load_path, game: str,
                     device="cuda", frame_size: int = 84,
                     frame_stack: int = 4, nlstm: int = 128):
    """The eval head of ``alg``/``network`` with the checkpoint at
    ``load_path`` loaded strictly, on ``device`` in eval mode."""
    module, _ = eval_head(alg, network, game, frame_size, frame_stack,
                          nlstm, device=device)
    module.load_state_dict(load_state_dict(load_path))
    return module


def make_tb_policy(alg: str, network: str, state_dict, game: str,
                   skip: int = 4, frame_size: int = 84,
                   frame_stack: int = 4, seed: int = 0, device="cuda"):
    """``action_fn(tb) -> int`` from a loaded checkpoint's state_dict
    (``state_dict=None``: the head's random weights), actions drawn with
    a generator seeded with ``seed`` on ``device`` (the facade's device).

    ``action_fn.reset()`` restarts the stack (after ``tb.new_game()``);
    ``action_fn.state`` holds the stack (uint8 [k, 84, 84]) and the last
    action."""
    if network in RECURRENT_NETWORKS:
        raise ValueError(
            f"the single-env adapter is feedforward-only; {network!r} "
            "checkpoints evaluate through the batched paths "
            "(sample_tests.runner.play_batched / regress), which thread "
            "the LSTM carry")
    module = get_game(game)
    legal = np.asarray(LEGAL_ACTIONS[game], np.int32)
    dev = torch.device(device)
    net, p_step = eval_head(alg, network, game, frame_size, frame_stack,
                            device=dev)
    if state_dict is not None:
        net.load_state_dict(state_dict)
    warp = obs_ops.make_warp(module.HEIGHT, module.WIDTH, frame_size, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    renderers = {}

    def render_gray(tb) -> torch.Tensor:
        config = tb.rsimulator.config
        if renderers.get("config") is not config:    # interventions
            renderers.update(config=config,
                             fn=_RENDERERS[game][0](config))
        return renderers["fn"](tb.rstate.tree)[0]         # u8 [H, W]

    state = {"stack": None, "g1": None, "frame": 0, "action": 0}

    def action_fn(tb) -> int:
        i = state["frame"]
        if i == 0:
            f = warp(render_gray(tb))
            state["stack"] = f[None].expand(frame_stack, -1, -1)
        elif i % skip == 0:
            # tb now shows the last frame of the previous macro step
            f = warp(torch.maximum(state["g1"], render_gray(tb)))
            state["stack"] = torch.cat([state["stack"][1:], f[None]])
        if i % skip == skip - 1:
            state["g1"] = render_gray(tb)
        if i % skip == 0:
            obs = state["stack"].permute(1, 2, 0)[None]     # NHWC
            actions = p_step(obs, gen)[0]
            state["action"] = int(legal[int(actions[0])])
        state["frame"] = i + 1
        return state["action"]

    def reset():
        state.update(stack=None, g1=None, frame=0, action=0)

    action_fn.reset = reset
    action_fn.state = state
    return action_fn
