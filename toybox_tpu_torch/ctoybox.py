"""The ``ctoybox`` facade (``Toybox``, ``Simulator``, ``State``, ``Input``)
over the port's engines (port of toybox_tpu.ctoybox).

This is the interactive single-env layer that interventions, the
behavioral scenarios' set-up and tests drive: one game, held as a batch
of one ([1, ...] tensors) of the port's batched engines on ``device``
(``cuda`` unless the caller asks for ``cpu``). JSON codecs run on the
host only when asked. Frames come from each game's plain ``render`` and
``luma2d``, as the JAX facade renders with ``render`` and not with the
frame kernels; the batched path (``envs.pipeline``) is the one that
launches them.

One engine frame at N = 1 is a few hundred small launches on the card,
so a long per-frame loop through the facade is slow there; the batched
env is the path for playing many frames.
"""

from __future__ import annotations

import dataclasses
import json as _json
from functools import partial

import numpy as np
import torch

from toybox_tpu_torch.core import rng as _rng
from toybox_tpu_torch.core.actions import LEGAL_ACTIONS, ale_to_input
from toybox_tpu_torch.core.types import Input
from toybox_tpu_torch.games import get_game
from toybox_tpu_torch.games.common import luma2d

__all__ = ["Toybox", "Simulator", "State", "Input"]


class Simulator:
    """Game factory and config holder (mirror of ctoybox.Simulator)."""

    def __init__(self, game_name: str, config=None, device="cuda"):
        self.game_name = game_name
        self.module = get_game(game_name)
        self.device = torch.device(device)
        self.config = (config if config is not None
                       else self.module.default_config(self.device))

    def new_game(self) -> "State":
        return State(self, self.module.new_game(self.config))

    def config_to_json(self) -> dict:
        return self.module.config_to_json(self.config)

    def schema_for_state(self) -> dict:
        return self.module.schema()


class State:
    """Raw state handle (mirror of ctoybox.State / tb.rstate).

    Native queries appear as methods named ``{game}_{query}``, e.g.
    ``breakout_bricks_remaining()``."""

    def __init__(self, simulator: Simulator, tree):
        self._sim = simulator
        self.tree = tree

    def to_json(self) -> dict:
        return self._sim.module.state_to_json(self._sim.config, self.tree)

    def __getattr__(self, name):
        prefix = self._sim.game_name + "_"
        if name.startswith(prefix):
            return partial(self._sim.module.query, self._sim.config,
                           self.tree, name[len(prefix):])
        raise AttributeError(name)


class Toybox:
    """Mirror of ctoybox.Toybox: owns a Simulator and the live State."""

    def __init__(self, game_name: str, grayscale: bool = True,
                 frameskip: int = 0, seed=None, withstate: dict | None = None,
                 device="cuda"):
        self.game_name = game_name
        self.frames_per_action = frameskip + 1
        self.grayscale = grayscale
        self.rsimulator = Simulator(game_name, device=device)
        if seed is not None:
            self.set_seed(seed)
        self.rstate = self.rsimulator.new_game()
        if withstate is not None:
            self.write_state_json(withstate)

    @property
    def device(self) -> torch.device:
        return self.rsimulator.device

    # -- lifecycle ---------------------------------------------------------
    def new_game(self) -> None:
        self.rstate = self.rsimulator.new_game()

    def set_seed(self, seed: int) -> None:
        """Re-seed the config's rng (the next new_game takes it); a config
        with no rng of its own (Gridworld's) is left as it is."""
        cfg = self.rsimulator.config
        if hasattr(cfg, "rand"):
            words = _rng.seed(torch.tensor(int(seed) & _rng.MASK32))
            self.rsimulator.config = dataclasses.replace(
                cfg, rand=tuple(words.tolist()))

    def close(self) -> None:
        self.rstate = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()

    # -- stepping ----------------------------------------------------------
    def apply_action(self, action_input: Input) -> None:
        """One action (a host Input of python bools, or a batched Input of
        bool tensors [1]) for ``frameskip + 1`` engine frames."""
        inp = Input(**{
            f.name: torch.as_tensor(getattr(action_input, f.name),
                                    device=self.device).reshape(1)
            for f in dataclasses.fields(Input)})
        sim = self.rsimulator
        tree = self.rstate.tree
        for _ in range(self.frames_per_action):
            tree = sim.module.step(sim.config, tree, inp)
        self.rstate = State(sim, tree)

    def apply_ale_action(self, action_int: int) -> None:
        self.apply_action(ale_to_input(torch.tensor([int(action_int)],
                                                    device=self.device)))

    # -- observation -------------------------------------------------------
    def _render(self) -> torch.Tensor:
        sim = self.rsimulator
        return sim.module.render(sim.config, self.rstate.tree)[0]

    def get_rgba_frame(self) -> np.ndarray:
        return self._render().cpu().numpy()

    def get_rgb_frame(self) -> np.ndarray:
        return self.get_rgba_frame()[:, :, :3]

    def get_state(self) -> np.ndarray:
        """Framebuffer as uint8 HxWxC: grayscale (1 channel) or RGBA."""
        img = self._render()
        if self.grayscale:
            return luma2d(img)[..., None].cpu().numpy()
        return img.cpu().numpy()

    def get_height(self) -> int:
        return self.rsimulator.module.HEIGHT

    def get_width(self) -> int:
        return self.rsimulator.module.WIDTH

    def save_frame_image(self, path: str, grayscale: bool | None = None):
        from PIL import Image
        gs = self.grayscale if grayscale is None else grayscale
        frame = self.get_state() if gs else self.get_rgba_frame()
        if frame.shape[-1] == 1:
            Image.fromarray(frame[:, :, 0], mode="L").save(path)
        else:
            Image.fromarray(frame, mode="RGBA").save(path)

    # -- score / lives -----------------------------------------------------
    def get_score(self) -> int:
        return int(self.rsimulator.module.score(self.rstate.tree)[0])

    def get_lives(self) -> int:
        return int(self.rsimulator.module.lives(self.rstate.tree)[0])

    def get_level(self) -> int:
        level = getattr(self.rstate.tree, "level", None)
        return 0 if level is None else int(level[0])

    def game_over(self) -> bool:
        return self.get_lives() <= 0

    # -- JSON state/config boundary ----------------------------------------
    def to_state_json(self) -> dict:
        return self.rstate.to_json()

    def write_state_json(self, js) -> None:
        if isinstance(js, str):
            js = _json.loads(js)
        sim = self.rsimulator
        self.rstate = State(sim, sim.module.state_from_json(sim.config, js))

    def config_to_json(self) -> dict:
        return self.rsimulator.config_to_json()

    def write_config_json(self, config_js) -> None:
        if isinstance(config_js, str):
            config_js = _json.loads(config_js)
        sim = self.rsimulator
        sim.config = sim.module.config_from_json(config_js, sim.device)

    def schema_for_state(self) -> dict:
        return self.rsimulator.schema_for_state()

    def schema_for_config(self) -> dict:
        return {"type": "object",
                "required": sorted(self.config_to_json().keys())}

    def query_state_json(self, query: str, args="null"):
        if isinstance(args, str):
            args = _json.loads(args)
        sim = self.rsimulator
        return sim.module.query(sim.config, self.rstate.tree, query, args)

    def get_legal_action_set(self) -> list:
        return list(LEGAL_ACTIONS[self.game_name])
