"""Game engines and their registry (port of toybox_tpu.games): Breakout,
Space Invaders, Amidar and Gridworld."""

from toybox_tpu_torch.games import amidar, breakout, gridworld, space_invaders

GAMES = {"breakout": breakout, "space_invaders": space_invaders,
         "amidar": amidar, "gridworld": gridworld}


def get_game(name: str):
    """The engine module of a game."""
    try:
        return GAMES[name]
    except KeyError:
        raise ValueError(f"unknown game {name!r}; have "
                         f"{sorted(GAMES)}") from None


def register_game(name: str, module) -> None:
    """Add (or replace) a game engine module under ``name``."""
    GAMES[name] = module
