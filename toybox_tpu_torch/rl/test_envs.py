"""Fake-env fixtures for learning tests (port of toybox_tpu.rl.test_envs
``make_discrete_identity_env``, ``make_box_identity_env``,
``make_fixed_sequence_env`` and ``make_image_class_env``, the reference's
DiscreteIdentityEnv, BoxIdentityEnv, FixedSequenceEnv and MnistEnv): tiny
seeded tasks whose optimal return is known.

Each follows the BatchedEnvFns protocol (reset/step over a state whose
``frames`` field is the observation). Their draws come from
``torch.Generator``s (held in the state and advanced in place), so the
numbers differ from the JAX fixtures'; the tasks are the same. The box
env also takes its targets as a tensor, and the image-class env its
templates and per-step draws, so that a test can feed them the JAX env's.
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


@dataclasses.dataclass(frozen=True)
class BoxIdentityState:
    frames: torch.Tensor          # f32[N, dim] the target
    target: torch.Tensor          # f32[N, dim]
    t: torch.Tensor               # i32[N] steps into the episode
    generator: torch.Generator    # draws the targets (advanced in place)
    drawn: int = 0                # targets drawn so far, the reset's too


def make_box_identity_env(num_envs: int, dim: int = 2, episode_len: int = 50,
                          device="cuda", targets=None) -> BatchedEnvFns:
    """Continuous control: the observation is a target uniform in
    [-1, 1)^dim and the reward -||action - target||^2; a new target every
    step. ``targets`` [steps + 1, N, dim], when given, replaces the draws:
    the reset's target is its row 0, step t's next target row t + 1."""
    dev = torch.device(device)

    def _new(gen, drawn):
        if targets is not None:
            return torch.as_tensor(targets[drawn], dtype=F32, device=dev)
        return torch.rand((num_envs, dim), generator=gen,
                          device=dev) * 2.0 - 1.0

    def reset(seeds):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(torch.as_tensor(seeds).sum()))
        target = _new(gen, 0)
        st = BoxIdentityState(frames=target, target=target,
                              t=torch.zeros(num_envs, dtype=I32, device=dev),
                              generator=gen, drawn=1)
        return st, target

    def step(state: BoxIdentityState, actions):
        err = torch.square(torch.as_tensor(actions, dtype=F32, device=dev)
                           - state.target).sum(-1)
        reward = -err
        target = _new(state.generator, state.drawn)
        t = state.t + 1
        done = t >= episode_len
        t = torch.where(done, torch.zeros_like(t), t)
        st = BoxIdentityState(frames=target, target=target, t=t,
                              generator=state.generator,
                              drawn=state.drawn + 1)
        nan = torch.full((), float("nan"), device=dev)
        info = {"lives": torch.ones(num_envs, dtype=I32, device=dev),
                "score": torch.zeros(num_envs, dtype=I32, device=dev),
                "episode_return": torch.where(
                    done, torch.zeros((), device=dev), nan),
                "episode_length": torch.where(
                    done, torch.full_like(t, episode_len),
                    torch.zeros_like(t)),
                "raw_reward": reward}
        return st, target, reward, done, info

    return BatchedEnvFns(game_name="box_identity", num_envs=num_envs,
                         obs_mode="vector", reset=reset, step=step,
                         obs_shape=(dim,), num_actions=dim,
                         legal_actions=())


@dataclasses.dataclass(frozen=True)
class FixedSeqState:
    frames: torch.Tensor          # f32[N, 1] t / episode_len
    t: torch.Tensor               # i32[N] steps into the episode


def make_fixed_sequence_env(num_envs: int, n_actions: int = 10,
                            episode_len: int = 100, seed: int = 0,
                            device="cuda") -> BatchedEnvFns:
    """Reward 1 for emitting the fixed action of each step, the sequence
    drawn once from a generator seeded with ``seed``: a memorization
    task. The observation is the step's index over episode_len."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    seq = torch.randint(0, n_actions, (episode_len,), generator=gen,
                        device=dev)

    def reset(seeds):
        frames = torch.zeros((num_envs, 1), dtype=F32, device=dev)
        return FixedSeqState(frames=frames, t=torch.zeros(
            num_envs, dtype=I32, device=dev)), frames

    def step(state: FixedSeqState, actions):
        correct = seq[state.t.clamp(0, episode_len - 1).long()]
        reward = (torch.as_tensor(actions, device=dev).long()
                  == correct).to(F32)
        t = state.t + 1
        done = t >= episode_len
        t = torch.where(done, torch.zeros_like(t), t)
        frames = t.to(F32)[:, None] / episode_len
        nan = torch.full((), float("nan"), device=dev)
        info = {"lives": torch.ones(num_envs, dtype=I32, device=dev),
                "score": torch.zeros(num_envs, dtype=I32, device=dev),
                "episode_return": torch.where(
                    done, torch.zeros((), device=dev), nan),
                "episode_length": torch.where(
                    done, torch.full_like(t, episode_len),
                    torch.zeros_like(t)),
                "raw_reward": reward}
        return FixedSeqState(frames=frames, t=t), frames, reward, done, info

    return BatchedEnvFns(game_name="fixed_sequence", num_envs=num_envs,
                         obs_mode="vector", reset=reset, step=step,
                         obs_shape=(1,), num_actions=n_actions,
                         legal_actions=tuple(range(n_actions)))


@dataclasses.dataclass(frozen=True)
class ImageClassState:
    frames: torch.Tensor          # u8[N, H, W, 1] the current class image
    target: torch.Tensor          # int64[N] the correct class (action)
    t: torch.Tensor               # i32[N] steps into the episode
    ret: torch.Tensor             # f32[N] the episode's reward so far
    generator: torch.Generator    # draws classes and noise (in place)
    drawn: int = 0                # images drawn so far, the reset's too


def make_image_class_env(num_envs: int, n_classes: int = 10, size: int = 28,
                         episode_len: int = 10, noise: float = 0.05,
                         seed: int = 0, device="cuda", templates=None,
                         targets=None, flips=None) -> BatchedEnvFns:
    """Image classification as RL (the reference's MnistEnv without the
    download): each class is a fixed random binary template, u8[size,
    size, 1] of 0 or 255 drawn from a CPU generator seeded with ``seed``
    unless ``templates`` [n_classes, size, size, 1] is given; every step
    shows each env a fresh class image with each pixel flipped (255 - v)
    with probability ``noise``, and the reward is 1 when the action names
    the class of the image the env showed. Only a policy that reads the
    image beats 1 / n_classes.

    ``targets`` int[k, N] and ``flips`` bool[k, N, size, size, 1], when
    given, replace the draws: the reset's image is row 0, step t's next
    image row t + 1."""
    dev = torch.device(device)
    if templates is None:
        gen = torch.Generator().manual_seed(seed)
        templates = (torch.rand((n_classes, size, size, 1), generator=gen)
                     < 0.5).to(torch.uint8) * 255
    templates = torch.as_tensor(templates, dtype=torch.uint8, device=dev)

    def _new(gen, drawn):
        if targets is not None:
            target = torch.as_tensor(targets[drawn], device=dev).long()
            flip = torch.as_tensor(flips[drawn], device=dev)
        else:
            target = torch.randint(0, n_classes, (num_envs,), generator=gen,
                                   device=dev)
            flip = torch.rand((num_envs, size, size, 1), generator=gen,
                              device=dev) < noise
        img = templates[target]
        return target, torch.where(flip, 255 - img, img)

    def reset(seeds):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(torch.as_tensor(seeds).sum()))
        target, frames = _new(gen, 0)
        st = ImageClassState(
            frames=frames, target=target,
            t=torch.zeros(num_envs, dtype=I32, device=dev),
            ret=torch.zeros(num_envs, dtype=F32, device=dev),
            generator=gen, drawn=1)
        return st, frames

    def step(state: ImageClassState, actions):
        reward = (torch.as_tensor(actions, device=dev).long()
                  == state.target).to(F32)
        t = state.t + 1
        ret = state.ret + reward
        done = t >= episode_len
        target, frames = _new(state.generator, state.drawn)
        zero = torch.zeros((), device=dev)
        st = ImageClassState(frames=frames, target=target,
                             t=torch.where(done, torch.zeros_like(t), t),
                             ret=torch.where(done, zero, ret),
                             generator=state.generator,
                             drawn=state.drawn + 1)
        nan = torch.full((), float("nan"), device=dev)
        info = {"lives": torch.ones(num_envs, dtype=I32, device=dev),
                "score": torch.zeros(num_envs, dtype=I32, device=dev),
                "episode_return": torch.where(done, ret, nan),
                "episode_length": torch.where(
                    done, torch.full_like(t, episode_len),
                    torch.zeros_like(t)),
                "raw_reward": reward}
        return st, frames, reward, done, info

    return BatchedEnvFns(game_name="image_class", num_envs=num_envs,
                         obs_mode="grayscale", reset=reset, step=step,
                         obs_shape=(size, size, 1), num_actions=n_classes,
                         legal_actions=tuple(range(n_classes)))
