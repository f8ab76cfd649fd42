"""Fake-env fixture for learning tests (port of toybox_tpu.rl.test_envs
``make_discrete_identity_env``, the reference's DiscreteIdentityEnv): a
tiny seeded task whose optimal return is known.

It follows the BatchedEnvFns protocol (reset/step over a state whose
``frames`` field is the observation). Its targets come from a
``torch.Generator`` held in the state and advanced in place, so the
numbers differ from the JAX fixture's; the task is the same.
"""

from __future__ import annotations

import dataclasses

import torch

from toybox_tpu_torch.envs.batched import BatchedEnvFns

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class IdentityState:
    frames: torch.Tensor          # f32[N, dim] one-hot of the target
    target: torch.Tensor          # int64[N] the correct action
    t: torch.Tensor               # i32[N] steps into the episode
    generator: torch.Generator    # draws the targets (advanced in place)


def make_discrete_identity_env(num_envs: int, dim: int = 10,
                               episode_len: int = 100,
                               device="cuda") -> BatchedEnvFns:
    """Reward 1 iff action == the observed one-hot index."""
    dev = torch.device(device)

    def _new_target(gen):
        target = torch.randint(0, dim, (num_envs,), generator=gen,
                               device=dev)
        return target, torch.nn.functional.one_hot(target, dim).to(F32)

    def reset(seeds):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(torch.as_tensor(seeds).sum()))
        target, frames = _new_target(gen)
        st = IdentityState(frames=frames, target=target,
                           t=torch.zeros(num_envs, dtype=I32, device=dev),
                           generator=gen)
        return st, frames

    def step(state: IdentityState, actions):
        reward = (torch.as_tensor(actions, device=dev).long()
                  == state.target).to(F32)
        target, frames = _new_target(state.generator)
        t = state.t + 1
        done = t >= episode_len
        t = torch.where(done, torch.zeros_like(t), t)
        st = IdentityState(frames=frames, target=target, t=t,
                           generator=state.generator)
        nan = torch.full((), float("nan"), device=dev)
        info = {"lives": torch.ones(num_envs, dtype=I32, device=dev),
                "score": torch.zeros(num_envs, dtype=I32, device=dev),
                "episode_return": torch.where(done, t.to(F32), nan),
                "episode_length": torch.where(
                    done, torch.full_like(t, episode_len),
                    torch.zeros_like(t)),
                "raw_reward": reward}
        return st, frames, reward, done, info

    return BatchedEnvFns(game_name="discrete_identity", num_envs=num_envs,
                         obs_mode="vector", reset=reset, step=step,
                         obs_shape=(dim,), num_actions=dim,
                         legal_actions=tuple(range(dim)))
