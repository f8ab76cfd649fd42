"""Game engines and their registry (port of toybox_tpu.games): Breakout,
Space Invaders and Amidar; Gridworld is not ported yet."""

from toybox_tpu_torch.games import amidar, breakout, space_invaders

GAMES = {"breakout": breakout, "space_invaders": space_invaders,
         "amidar": amidar}
NOT_PORTED = ("gridworld",)


def get_game(name: str):
    """The engine module of a ported game."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"game {name!r} is not ported yet; have "
                                  f"{sorted(GAMES)}")
    try:
        return GAMES[name]
    except KeyError:
        raise ValueError(f"unknown game {name!r}; have "
                         f"{sorted(GAMES)}") from None
