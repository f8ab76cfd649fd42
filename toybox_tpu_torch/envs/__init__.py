"""Env layer (port of toybox_tpu.envs): the batched device envs, the
DeepMind observation pipeline, and the gymnasium surface.

Registers {Breakout,Amidar,SpaceInvaders,GridWorld}ToyboxNoFrameskip-v4
under the gymnasium namespace ``toybox_tpu_torch`` (e.g.
``toybox_tpu_torch/BreakoutToyboxNoFrameskip-v4``), so that they stand
beside the JAX package's ids of the same names without replacing them.
``gym_id`` maps a reference id onto the port's; ``wrappers.make_atari``
and ``vec_env.make_vec_env`` take the reference names. Without gymnasium
nothing is registered and the batched envs work as before.
"""

NAMESPACE = "toybox_tpu_torch"
GAME_CLASSES = {"Breakout": "BreakoutEnv", "Amidar": "AmidarEnv",
                "SpaceInvaders": "SpaceInvadersEnv",
                "GridWorld": "GridWorldEnv"}
SUFFIX = "ToyboxNoFrameskip-v4"

_REGISTERED = False


def gym_id(env_id: str) -> str:
    """The port's gymnasium id of a Toybox env id (reference names gain
    the namespace); other ids (real ALE) are returned as they are."""
    if "Toybox" in env_id and "/" not in env_id:
        return f"{NAMESPACE}/{env_id}"
    return env_id


def register_envs() -> None:
    global _REGISTERED
    if _REGISTERED:
        return
    try:
        from gymnasium.envs.registration import register
    except ImportError:
        return
    for game, cls in GAME_CLASSES.items():
        # Breakout is nondeterministic: the config rng varies the serve
        register(id=gym_id(game + SUFFIX),
                 entry_point=f"toybox_tpu_torch.envs.atari:{cls}",
                 nondeterministic=game == "Breakout")
    _REGISTERED = True


register_envs()
