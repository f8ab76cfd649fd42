"""RL-ready batched env: the DeepMind preprocessing stack on the device
(port of toybox_tpu.envs.pipeline ``make_rl_env``).

- skip-4 stepping, where only the last two of every four frames are
  rendered, by the game's fused max-pool frame kernel (ops/render_cuda.py,
  render_si.py, render_amidar.py); a game with no frame kernel
  (Gridworld, as in the JAX package) takes the max of two
  ``luma2d(render)`` frames, in plain torch ops;
- the 84x84 bilinear warp as two f32 matmuls, or with
  ``inkernel_warp=True`` inside the fused frame kernel (the reset frame is
  still warped by the matmuls, as in the JAX package);
- a 4-frame stack kept channel-first [N, 4, 84, 84], with an NHWC
  ``frames`` view at the public boundary, as in the JAX package;
- episodic life (the stack restarts on life loss) and sign-clipped reward;
- ``reset_to``: every env from one game state, as the behavioral gate
  starts its episodes from an intervened state.

step() returns obs uint8 [N, 84, 84, stack].
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from toybox_tpu_torch.envs.batched import BatchedEnvFns, make_batched_env
from toybox_tpu_torch.games import get_game
from toybox_tpu_torch.games.common import luma2d
from toybox_tpu_torch.ops import obs as obs_ops
from toybox_tpu_torch.ops import render_amidar, render_cuda, render_si

I32 = torch.int32
F32 = torch.float32

_RENDERERS = {
    "breakout": (render_cuda.make_breakout_gray_renderer,
                 render_cuda.make_breakout_gray_maxpool_renderer),
    "space_invaders": (render_si.make_si_gray_renderer,
                       render_si.make_si_gray_maxpool_renderer),
    "amidar": (render_amidar.make_amidar_gray_renderer,
               render_amidar.make_amidar_gray_maxpool_renderer),
}
#: the games whose frames the pipeline renders with a CUDA frame kernel
FRAME_KERNEL_GAMES = tuple(_RENDERERS)


@dataclasses.dataclass(frozen=True)
class PipelineState:
    env: Any                 # inner EnvState
    stack: torch.Tensor      # uint8[N, k, 84, 84] frame stack (channel-first)
    lives: torch.Tensor      # i32[N] previous lives (episodic life)

    @property
    def frames(self) -> torch.Tensor:
        """Observation view: NHWC uint8 [N, 84, 84, k]."""
        return self.stack.permute(0, 2, 3, 1)


def make_rl_env(game_name: str, num_envs: int, config=None, skip: int = 4,
                frame_size: int = 84, frame_stack: int = 4,
                episodic_life: bool = True, clip_rewards: bool = True,
                inkernel_warp: bool = False, seed_stride=None,
                device="cuda") -> BatchedEnvFns:
    """BatchedEnvFns with DeepMind preprocessing:
    step(state, actions) -> (state, obs[N,84,84,k], reward, done, info),
    where done marks life loss under episodic_life (the env auto-resets
    itself on true game over). ``inkernel_warp`` warps each step's
    max-pooled frame inside the frame kernel (one launch per step, only
    [N, 84, 84] written) instead of with two matmuls after it; for a
    game with no frame kernel it raises ValueError. ``seed_stride`` is
    the auto-reset's (``make_batched_env``)."""
    if skip < 2:
        raise ValueError("make_rl_env requires skip >= 2 (the last two "
                         "frames are always rendered for the max-pool)")
    module = get_game(game_name)
    cfg = config if config is not None else module.default_config(device)
    dev = cfg.device
    inner = make_batched_env(game_name, num_envs, config=cfg,
                             obs_mode="none", fast_auto_reset=True,
                             seed_stride=seed_stride)
    if game_name in _RENDERERS:
        factory, factory2 = _RENDERERS[game_name]
        render_gray = factory(cfg)
        warp = obs_ops.make_warp(module.HEIGHT, module.WIDTH, frame_size,
                                 dev)
        if inkernel_warp:
            render_max_warp = factory2(cfg, warp_to=frame_size)
        else:
            render_max = factory2(cfg)

            def render_max_warp(g1, g2):
                return warp(render_max(g1, g2))
    else:
        if inkernel_warp:
            raise ValueError(f"inkernel_warp: {game_name!r} has no frame "
                             f"kernel (only {', '.join(FRAME_KERNEL_GAMES)})")
        warps = {}

        def render_gray(game):
            return luma2d(module.render(cfg, game))

        def warp(frames):
            """The matmul warp built for the frame's own size (a config
            may give another grid than the default's)."""
            h, w = frames.shape[-2:]
            if (h, w) not in warps:
                warps[h, w] = obs_ops.make_warp(h, w, frame_size, dev)
            return warps[h, w](frames)

        def render_max_warp(g1, g2):
            return warp(torch.maximum(render_gray(g1), render_gray(g2)))

    def restart(frame):
        return frame[:, None].expand(-1, frame_stack, -1, -1)

    def _wrap(env_state):
        frame = warp(render_gray(env_state.game))          # [N, 84, 84]
        state = PipelineState(env=env_state,
                              stack=restart(frame).contiguous(),
                              lives=module.lives(env_state.game).to(I32))
        return state, state.frames

    def reset(seeds):
        return _wrap(inner.reset(seeds)[0])

    def reset_to(tree, seeds, reseed: bool = True):
        """Start every env from one env's game state (see the batched
        env's ``reset_to``); the frame stack restarts from its frame."""
        return _wrap(inner.reset_to(tree, seeds, reseed=reseed)[0])

    def step(state: PipelineState, actions):
        env_state = state.env
        total_r = torch.zeros(num_envs, dtype=F32, device=dev)
        done_any = torch.zeros(num_envs, dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=F32, device=dev)

        # The inner env auto-resets mid-macro-step; once an episode has
        # finished, later inner frames belong to the new episode and their
        # rewards must not leak into the finishing episode's return.
        def inner_step(env_state, total_r, done_any):
            env_state, _, r, d, info = inner.step(env_state, actions)
            return (env_state, total_r + torch.where(done_any, zero, r),
                    done_any | d, info)

        for _ in range(skip - 1):
            env_state, total_r, done_any, _ = inner_step(
                env_state, total_r, done_any)
        g1 = env_state.game
        env_state, total_r, done_any, info = inner_step(
            env_state, total_r, done_any)

        frame = render_max_warp(g1, env_state.game)        # [N, 84, 84]
        stack = torch.cat([state.stack[:, 1:], frame[:, None]], 1)

        lives = info["lives"]
        if episodic_life:
            life_lost = (lives < state.lives) | done_any
        else:
            life_lost = done_any
        # fresh episode (auto-reset or life loss): restart the stack
        stack = torch.where(life_lost[:, None, None, None], restart(frame),
                            stack)

        reward = obs_ops.clip_reward(total_r) if clip_rewards else total_r
        new_state = PipelineState(env=env_state, stack=stack, lives=lives)
        info = dict(info)
        info["raw_reward"] = total_r
        return new_state, new_state.frames, reward, life_lost, info

    return BatchedEnvFns(
        game_name=game_name, num_envs=num_envs, obs_mode="stacked_gray",
        reset=reset, step=step,
        obs_shape=(frame_size, frame_size, frame_stack),
        num_actions=inner.num_actions, legal_actions=inner.legal_actions,
        frames_per_step=skip, reset_to=reset_to)
