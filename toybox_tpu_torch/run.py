"""Training CLI (port of toybox_tpu.run, the reference baselines/run.py
surface); the ported learners are ppo (recurrent too, with
--network=lstm|cnn_lstm|cnn_lnlstm), ppo1, a2c (recurrent too), acktr,
deepq (alias dqn), acer (recurrent too), trpo (alias trpo_mpi) and gail
(with behavior cloning; --load_path is its expert):

    python -m toybox_tpu_torch.run \
        --alg=ppo|ppo1|a2c|acktr|deepq|acer|trpo|gail \
        --env=BreakoutToyboxNoFrameskip-v4 --num_timesteps=1e6 \
        [--num_envs=64] [--network=...] [--save_path=...] [--play] \
        [--device=cuda]

It maps the env id onto the batched device envs (the game name from
<Game>ToyboxNoFrameskip-v4), resolves the per-alg defaults, passes
--key=value extras through to learn() as python literals, and plays the
trained policy with --play. --multi_host joins the process group of a
launcher (``torchrun``'s environment), offsets the seed by rank and logs
and saves on rank 0 only; each process runs its own learn, as in JAX:

    torchrun --nproc_per_node=N -m toybox_tpu_torch.run --multi_host ...

--save_path writes the policy as flax params,
which the JAX package's ``load_params`` reads. ddpg and her need a
continuous-action or goal env, as in JAX: --alg=ddpg and --alg=her raise
ValueError naming ``toybox_tpu_torch.rl.ddpg.learn`` and
``toybox_tpu_torch.rl.her.learn``.
"""

from __future__ import annotations

import argparse
import ast

import torch

from toybox_tpu_torch.regress import GAME_IDS, env_id_to_game, full_f32  # noqa: F401

ALG_DEFAULTS = {
    # reference ppo2/defaults.py:13-20
    "ppo": dict(nsteps=128, nminibatches=4, lam=0.95, gamma=0.99,
                noptepochs=4, ent_coef=0.01, lr=2.5e-4, cliprange=0.1,
                network="cnn"),
    "ppo2": "ppo",
    # reference a2c defaults
    "a2c": dict(nsteps=5, gamma=0.99, ent_coef=0.01, lr=7e-4,
                network="cnn"),
    # reference deepq/defaults.py:1-17
    "deepq": dict(network="conv_only", lr=1e-4, buffer_size=10000,
                  exploration_fraction=0.1, exploration_final_eps=0.01,
                  train_freq=4, learning_starts=10000,
                  target_network_update_freq=1000, gamma=0.99,
                  prioritized_replay=True, dueling=True),
    "dqn": "deepq",
    # reference trpo_mpi atari defaults use cnn_small
    "trpo": dict(network="cnn_small", nsteps=512, max_kl=0.001,
                 cg_iters=10, cg_damping=0.1, vf_stepsize=3e-4, vf_iters=3),
    "trpo_mpi": "trpo",
    # reference acer defaults (acer/acer.py learn signature)
    "acer": dict(network="cnn_small", nsteps=20, lr=7e-4, q_coef=0.5,
                 ent_coef=0.01, replay_ratio=4, c=10.0, delta=1.0),
    # reference acktr defaults (acktr/acktr_disc.py)
    "acktr": dict(nsteps=20, lr=0.25, ent_coef=0.01, vf_coef=0.5,
                  kfac_clip=0.001),
    # reference ppo1/run_atari.py pposgd defaults
    "ppo1": dict(timesteps_per_actorbatch=256, clip_param=0.2,
                 entcoeff=0.01, optim_epochs=4, optim_stepsize=1e-3,
                 optim_batchsize=64, gamma=0.99, lam=0.95,
                 schedule="linear", network="cnn"),
    # reference gail defaults (TRPO generator; --load_path doubles as
    # the expert model to roll transitions from)
    "gail": dict(network="cnn_small", nsteps=32, generator="trpo",
                 bc_epochs=0),
}


def alg_defaults(alg: str) -> dict:
    """ALG_DEFAULTS of ``alg``, aliases resolved; ValueError naming the
    algs for an unknown one."""
    spec = ALG_DEFAULTS.get(alg)
    if isinstance(spec, str):
        spec = ALG_DEFAULTS[spec]
    if spec is None:
        raise ValueError(f"unknown alg {alg!r}; have "
                         f"{', '.join(ALG_DEFAULTS)}")
    return dict(spec)


def default_network(alg: str) -> str:
    """The network an alg's checkpoints use unless told otherwise."""
    return alg_defaults(alg).get("network", "cnn")


def common_arg_parser():
    parser = argparse.ArgumentParser(
        description="toybox_tpu_torch RL trainer (baselines.run surface)")
    parser.add_argument("--env", type=str,
                        default="BreakoutToyboxNoFrameskip-v4")
    parser.add_argument("--alg", type=str, default="ppo")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num_timesteps", type=float, default=1e6)
    parser.add_argument("--num_envs", "--num_env", dest="num_envs",
                        type=int, default=64)
    parser.add_argument("--network", type=str, default=None)
    parser.add_argument("--save_path", type=str, default=None)
    parser.add_argument("--load_path", type=str, default=None)
    parser.add_argument("--log_path", type=str, default=None)
    parser.add_argument("--play", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--multi_host", action="store_true", default=False,
        help="multi-process run under a launcher (torchrun): join its "
             "process group, per-process env-seed blocks, rank-0-only "
             "logging and saving (replaces the reference's mpi_fork/rank "
             "plumbing, run.py:186-191 + cmd_util.py:28-33)")
    return parser


def parse_cmdline_kwargs(args):
    """--key=value passthrough, values parsed as python literals."""
    def parse(v):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    out = {}
    for a in args:
        if not (a.startswith("--") and "=" in a):
            raise ValueError(f"bad extra argument {a!r} (want --key=value)")
        k, v = a[2:].split("=", 1)
        out[k] = parse(v)
    return out


def get_learn_function(alg: str):
    """(learn, default kwargs) of an algorithm."""
    if alg in ("ppo", "ppo2"):
        from toybox_tpu_torch.rl.ppo import learn
    elif alg == "a2c":
        from toybox_tpu_torch.rl.a2c import learn
    elif alg == "acktr":
        from toybox_tpu_torch.rl.acktr import learn
    elif alg in ("deepq", "dqn"):
        from toybox_tpu_torch.rl.dqn import learn
    elif alg == "acer":
        from toybox_tpu_torch.rl.acer import learn
    elif alg in ("trpo", "trpo_mpi"):
        from toybox_tpu_torch.rl.trpo import learn
    elif alg == "ppo1":
        from toybox_tpu_torch.rl.ppo1 import learn
    elif alg == "gail":
        from toybox_tpu_torch.rl.gail import learn
    elif alg in ("her", "ddpg"):
        raise ValueError(
            f"{alg} needs a goal/continuous-action env, not an ALE game "
            f"(same as the reference); use toybox_tpu_torch.rl.{alg}.learn "
            "directly")
    else:
        alg_defaults(alg)                 # ValueError for an unknown alg
    return learn, alg_defaults(alg)


def train(args, extra_kwargs):
    from toybox_tpu_torch.utils import logger

    seed, rank0, device = args.seed, True, args.device
    if args.multi_host:
        # the launcher's environment names the rendezvous, the rank and
        # the world size; on a host with several cards each process takes
        # the card of its local rank (processes share a card on a host
        # with fewer cards than processes)
        import os

        import torch.distributed as dist

        from toybox_tpu_torch.parallel.mesh import (backend_for,
                                                    initialize_distributed,
                                                    process_seed_offset)
        cards = torch.cuda.device_count()
        if device == "cuda" and "LOCAL_RANK" in os.environ and cards > 1:
            device = f"cuda:{int(os.environ['LOCAL_RANK']) % cards}"
        initialize_distributed(backend=backend_for(device))
        seed = process_seed_offset(seed, args.num_envs)
        rank0 = not dist.is_initialized() or dist.get_rank() == 0

    game = env_id_to_game(args.env)
    learn, kwargs = get_learn_function(args.alg)
    kwargs.update(extra_kwargs)
    if args.network:
        kwargs["network"] = args.network
    # rank-0-only logging (reference run.py:186-191)
    lg = logger.configure(dir=args.log_path if rank0 else None,
                          format_strs=None if rank0 else [])
    state = learn(game=game, num_envs=args.num_envs,
                  total_timesteps=int(args.num_timesteps), seed=seed,
                  save_path=args.save_path if rank0 else None,
                  load_path=args.load_path, logger=logger, device=device,
                  **kwargs)
    return state, lg


@torch.no_grad()
def play(args, state, n_envs=8, max_chunks=40, chunk=64):
    """Eval rollouts of the trained policy on ``n_envs`` batched envs for
    at most ``max_chunks`` chunks, printing each finished episode's raw
    return; the host reads the returns once per chunk of ``chunk`` agent
    steps. Returns them. The actions are JAX's eval heads':
    epsilon-greedy at 0.01 on a deepq Q network, else drawn from the
    policy's logits (the recurrent ones threading the carry)."""
    from toybox_tpu_torch.envs.pipeline import make_rl_env
    from toybox_tpu_torch.rl.distributions import CategoricalPd
    from toybox_tpu_torch.rl.dqn import QNetwork, epsilon_greedy

    game = env_id_to_game(args.env)
    dev = torch.device(args.device)
    env = make_rl_env(game, n_envs, episodic_life=False, clip_rewards=False,
                      device=dev)
    module = state.module
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st, _ = env.reset(torch.arange(n_envs, device=dev))
    totals = torch.zeros(n_envs, device=dev)
    recurrent = hasattr(module, "initial_carry")
    if recurrent:
        carry = module.initial_carry(n_envs)
        done = torch.zeros(n_envs, dtype=torch.bool, device=dev)
    returns = []
    for _ in range(max_chunks):
        finished = []
        for _ in range(chunk):
            if isinstance(module, QNetwork):
                actions = epsilon_greedy(module(st.frames), 0.01, gen)
            elif recurrent:
                logits, _, carry = module(st.frames, carry, done)
                actions = CategoricalPd(logits).sample(gen)
            else:
                actions = CategoricalPd(module(st.frames)[0]).sample(gen)
            st, _, _, done, info = env.step(st, actions)
            totals = totals + info["raw_reward"]
            finished.append(torch.where(done, totals, float("nan")))
            totals = torch.where(done, torch.zeros_like(totals), totals)
        done_returns = torch.stack(finished).cpu()
        for r in done_returns[~torch.isnan(done_returns)].tolist():
            print(f"episode_rew={r}")
            returns.append(r)
    return returns


def main(argv=None):
    parser = common_arg_parser()
    args, unknown = parser.parse_known_args(argv)
    extra = parse_cmdline_kwargs(unknown)
    full_f32()
    try:
        state, _ = train(args, extra)
        if args.play:
            play(args, state)
    finally:
        if args.multi_host and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
