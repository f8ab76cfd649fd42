"""Training CLI (port of toybox_tpu.run, the reference baselines/run.py
surface); of the learners, only PPO is ported so far:

    python -m toybox_tpu_torch.run --alg=ppo \
        --env=BreakoutToyboxNoFrameskip-v4 --num_timesteps=1e6 \
        [--num_envs=64] [--save_path=...] [--play] [--device=cuda]

It maps the env id onto the batched device envs (the game name from
<Game>ToyboxNoFrameskip-v4), resolves the per-alg defaults, passes
--key=value extras through to learn() as python literals, and plays the
trained policy with --play. --save_path writes the policy as flax params,
which the JAX package's ``ppo.load_params`` reads. Other algorithms raise
NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import ast

import torch

from toybox_tpu_torch.regress import env_id_to_game, full_f32

ALG_DEFAULTS = {
    # reference ppo2/defaults.py:13-20
    "ppo": dict(nsteps=128, nminibatches=4, lam=0.95, gamma=0.99,
                noptepochs=4, ent_coef=0.01, lr=2.5e-4, cliprange=0.1,
                network="cnn"),
    "ppo2": "ppo",
    # the other learners' network defaults (the JAX package's): the eval
    # heads read them (regress, sample_tests); the rest of each alg's
    # defaults comes with its learner
    "a2c": dict(network="cnn"),
    "deepq": dict(network="conv_only"),
    "dqn": "deepq",
    "trpo": dict(network="cnn_small"),
    "trpo_mpi": "trpo",
    "acer": dict(network="cnn_small"),
    "acktr": dict(),
    "ppo1": dict(network="cnn"),
    "gail": dict(network="cnn_small"),
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


# --play: envs, chunks and agent steps per chunk
PLAY_ENVS, PLAY_CHUNKS, PLAY_CHUNK = 8, 40, 64


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
        return learn, alg_defaults(alg)
    if alg not in ("her", "ddpg"):
        alg_defaults(alg)                 # ValueError for an unknown alg
    raise NotImplementedError(
        f"alg {alg!r}: its learner is not ported to toybox_tpu_torch yet "
        "(ROADMAP.md §1: the remaining learners); its checkpoints play "
        "through regress and sample_tests")


def train(args, extra_kwargs):
    from toybox_tpu_torch.utils import logger

    game = env_id_to_game(args.env)
    learn, kwargs = get_learn_function(args.alg)
    kwargs.update(extra_kwargs)
    if args.network:
        kwargs["network"] = args.network
    lg = logger.configure(dir=args.log_path)
    state = learn(game=game, num_envs=args.num_envs,
                  total_timesteps=int(args.num_timesteps), seed=args.seed,
                  save_path=args.save_path, load_path=args.load_path,
                  logger=logger, device=args.device, **kwargs)
    return state, lg


@torch.no_grad()
def play(args, state):
    """Eval rollouts of the trained policy on PLAY_ENVS batched envs,
    printing each finished episode's raw return; the host reads the
    returns once per chunk of PLAY_CHUNK agent steps. Returns them."""
    from toybox_tpu_torch.envs.pipeline import make_rl_env
    from toybox_tpu_torch.rl.distributions import CategoricalPd

    n_envs = PLAY_ENVS
    game = env_id_to_game(args.env)
    dev = torch.device(args.device)
    env = make_rl_env(game, n_envs, episodic_life=False, clip_rewards=False,
                      device=dev)
    module = state.module
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st, _ = env.reset(torch.arange(n_envs, device=dev))
    totals = torch.zeros(n_envs, device=dev)
    returns = []
    for _ in range(PLAY_CHUNKS):
        finished = []
        for _ in range(PLAY_CHUNK):
            logits, _ = module(st.frames)
            st, _, _, done, info = env.step(
                st, CategoricalPd(logits).sample(gen))
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
    state, _ = train(args, extra)
    if args.play:
        play(args, state)
    return state


if __name__ == "__main__":
    main()
