"""Intervention registry (reference toybox/interventions/__init__.py:7-24;
a copy of toybox_tpu.interventions over the port's facade)."""

from toybox_tpu_torch.ctoybox import Toybox
from toybox_tpu_torch.interventions.amidar import Amidar, AmidarIntervention
from toybox_tpu_torch.interventions.base import SetEq, StandardEq
from toybox_tpu_torch.interventions.breakout import (Breakout,
                                                     BreakoutIntervention)
from toybox_tpu_torch.interventions.core import Game
from toybox_tpu_torch.interventions.space_invaders import (
    SpaceInvaders, SpaceInvadersIntervention)


def get_intervener(game_name):
    return {
        "breakout": BreakoutIntervention,
        "amidar": AmidarIntervention,
        "spaceinvaders": SpaceInvadersIntervention,
        "space_invaders": SpaceInvadersIntervention,
    }[game_name]


def get_state_object(game_name):
    return {
        "breakout": Breakout,
        "amidar": Amidar,
        "spaceinvaders": SpaceInvaders,
        "space_invaders": SpaceInvaders,
    }[game_name]


def state_from_toybox(toybox: Toybox, eq_mode=StandardEq):
    state_obj = get_state_object(toybox.game_name)
    with get_intervener(toybox.game_name)(toybox, eq_mode=eq_mode) as iv:
        return state_obj.decode(iv, toybox.to_state_json(), state_obj)
